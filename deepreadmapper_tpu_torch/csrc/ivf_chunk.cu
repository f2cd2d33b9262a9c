// The IVF chunk scans: per visit (QTK queries x one slab's chunks), score
// every row against every query and keep, per query and per strided lane
// window (row offset mod KP), the best and second-best (score, row id); then
// store that state per visit (packed), or fold it into a per-query
// accumulator of FS sorted slots per window (fold).
//
// Replaces, in deepreadmapper_tpu/ops/ivf_kernel.py:
//   ivf_chunk_int8       _int8_chunk_kernel      (ivf_chunk_scan_int8)
//   ivf_chunk_int8_fold  _int8_chunk_fold_kernel (ivf_chunk_scan_int8_fold)
//   ivf_chunk_pq         _pq_chunk_kernel        (ivf_chunk_scan_pq)
//   ivf_chunk_pq_fold    _pq_chunk_fold_kernel   (ivf_chunk_scan_pq_fold)
// the IVFINT8 / IVFPQ engines' probed-slab scans.
//
// Semantics (held bit for bit against the JAX kernels in interpret mode):
// score = rn - ratio2 * (q . r), one rounding (an FMA, as XLA rounds it);
// each lane window keeps its two lowest scores in visit order with a strict
// '<' (earlier rows win ties; unset slots stay (3.4e38, 0)); a fold inserts
// a visit's best then second-best into the FS ascending slots with a strict
// '<', visits in ascending visit id.
//
// What bounds it on an H100: device memory.  A chunk step reads 2048 rows
// x (128 B + 4 B norm) and does 32 x 2048 x 128 x 2 int8 operations, ~62
// operations per byte, far below the card's ~590 int8 operations per byte
// of bandwidth: the int8 scan has to stream bytes, not add math.
//
// Design: the TPU runs one grid step per (visit, chunk) and carries the
// visit's state across steps in VMEM scratch, folding into a VMEM-resident
// accumulator at each visit's last step.  Hopper blocks run in no order, so
// one block per visit walks that visit's chunk steps in order (the
// sequential grid becomes a loop, so a visit's steps are serial: the
// engine cuts the plan's padding steps, all of one pad visit over the
// empty dump chunk, before it launches).
//  - The int8 scan (ivf_chunk_int8): a chunk step is 16 slabs of KP = 128
//    rows, and slab row p is lane window p.  The slabs of all the visit's
//    steps arrive in order by cp.async (rows at a 144-byte pitch, with
//    their 128 norms) into a ring of four slabs, three ahead of the one
//    being scored, one barrier a slab.  Warp w owns slab rows 16w .. 16w+15
//    (one m16 tile) for all 32 queries (four n8 tiles): per slab 4 k32 steps
//    x 4 n-tiles = 16 int8 mma.sync m16n8k32, A fragments by ldmatrix, the
//    visit's B fragments staged once in shared memory in fragment order.  A
//    thread's 16 accumulators map to the same (lane window, query) pairs in
//    every slab, so its best / second-best ladders live in registers and see
//    their rows in ascending order: the strict '<' gives the TPU's tie rule
//    with no cross-thread merge.  The common ladder update is one compare
//    against the second-best.  At the visit's end the 64 KB state goes out
//    through a shared-memory transpose (reusing the ring) as 16-byte stores.
//  - The PQ scans: thread (lane, group) owns lane window `lane` for the
//    group's QPT queries and scans rows lane, lane + KP, ... of each chunk
//    in ascending order.  Each row is rebuilt from its byte-packed codes
//    through the int8 codebook staged in shared memory (ksub x 128 B) into
//    registers (the next one is prefetched) and scored with __dp4a against
//    the visit's queries, read from shared memory as warp-wide broadcasts;
//    the 32 x KP x 4 state lives in registers (QPT x 4 per thread).
//  - The fold runs as a second kernel over the packed per-visit states:
//    thread (query, lane) walks the query's visit rows in ascending visit
//    id (an index the wrapper sorts) and inserts.  A single-pass fold that
//    inserted visits as blocks finish would order ties by block timing; two
//    passes cost the [V, QTK, 4 KP] buffer the TPU kept out of HBM.
#include "winmin.cuh"

namespace {

using winmin::dot16;

constexpr int QTK = 32;               // queries per visit
constexpr int KP = 128;               // lane windows per visit
constexpr int CHK = 2048;             // rows per chunk
constexpr int FS = 4;                 // fold slots per window
constexpr int V = winmin::V;          // int4 per 128-byte row
constexpr int QG = 2;                 // query groups per block
constexpr int QPT = QTK / QG;         // queries per thread
constexpr int THREADS = KP * QG;      // one visit per block
constexpr int FOLD_Q = 2;             // queries per fold block
constexpr int ROWS_PER_STEP = CHK / KP;
constexpr float BIG = winmin::BIG;

// Rows of the PQ layout: packed [n_chunks][MP][CHK] int32, code j in byte
// j % 4 of word j / 4; cb is the int8 codebook [M * ksub][128 / M] staged
// in shared memory, as 32-bit words.
template <int M>
struct PqRows {
  static constexpr int MP = (M + 3) / 4;
  static constexpr int DW = 32 / M;   // codebook words per subspace entry
  const int* packed;
  const int* cb;
  int ksub;
  __device__ __forceinline__ void load(int chunk, int off, int4 (&r)[V]) const {
    const int* base = packed + (size_t)chunk * MP * CHK + off;
    int words[MP];
#pragma unroll
    for (int p = 0; p < MP; ++p) words[p] = __ldg(base + (size_t)p * CHK);
    int w[32];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int code = (words[j / 4] >> (8 * (j % 4))) & 255;
      const int* src = cb + (j * ksub + code) * DW;
#pragma unroll
      for (int u = 0; u < DW; ++u) w[j * DW + u] = src[u];
    }
#pragma unroll
    for (int c = 0; c < V; ++c) r[c] = make_int4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
  }
};

struct State {
  float b1[QPT], b2[QPT];
  int a1[QPT], a2[QPT];
};

template <class Rows>
__device__ __forceinline__ void fetch(const Rows& rows, const int* step_chunk, int first,
                                      const float* rn, int lane, int it, int4 (&r)[V],
                                      float& rv, int& cand) {
  const int chunk = __ldg(step_chunk + first + it / ROWS_PER_STEP);
  const int off = (it % ROWS_PER_STEP) * KP + lane;
  rows.load(chunk, off, r);
  rv = __ldg(rn + (size_t)chunk * CHK + off);
  cand = chunk * CHK + off;
}

// The visit's scan: rows lane, lane + KP, ... of each step's chunk, steps in
// order, each scored against this thread's QPT queries and folded into the
// best / second-best ladder.
template <class Rows>
__device__ __forceinline__ void scan_visit(const Rows& rows, const int* step_chunk,
                                           int first, int count, const float* rn,
                                           const int4* qs, float ratio2, State& st) {
  const int lane = threadIdx.x % KP;
  const int q0 = (threadIdx.x / KP) * QPT;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    st.b1[j] = st.b2[j] = BIG;
    st.a1[j] = st.a2[j] = 0;
  }
  const int total = count * ROWS_PER_STEP;
  if (total <= 0) return;
  int4 cur[V];
  float rcur;
  int ccur;
  fetch(rows, step_chunk, first, rn, lane, 0, cur, rcur, ccur);
  for (int it = 0; it < total; ++it) {
    int4 nxt[V];
    float rnx = 0.f;
    int cnx = 0;
    if (it + 1 < total) fetch(rows, step_chunk, first, rn, lane, it + 1, nxt, rnx, cnx);
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int4* q = qs + (q0 + j) * V;
      int acc = 0;
#pragma unroll
      for (int c = 0; c < V; ++c) acc = dot16(cur[c], q[c], acc);
      const float s = __fmaf_rn(-ratio2, (float)acc, rcur);
      if (s < st.b1[j]) {
        st.b2[j] = st.b1[j];
        st.a2[j] = st.a1[j];
        st.b1[j] = s;
        st.a1[j] = ccur;
      } else if (s < st.b2[j]) {
        st.b2[j] = s;
        st.a2[j] = ccur;
      }
    }
    if (it + 1 < total) {
#pragma unroll
      for (int c = 0; c < V; ++c) cur[c] = nxt[c];
      rcur = rnx;
      ccur = cnx;
    }
  }
}

// The visit's QTK query rows into shared memory.
__device__ __forceinline__ void stage_queries(const int8_t* qsteps, int visit, int4* qs) {
  const int4* src = reinterpret_cast<const int4*>(qsteps) + (size_t)visit * QTK * V;
  for (int i = threadIdx.x; i < QTK * V; i += THREADS) qs[i] = src[i];
}

// Packed per-visit block [QTK][4 KP]: vals | vals2 | args | args2.
__device__ __forceinline__ void store_state(float* out, int visit, const State& st) {
  const int lane = threadIdx.x % KP;
  const int q0 = (threadIdx.x / KP) * QPT;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    float* p = out + ((size_t)visit * QTK + q0 + j) * 4 * KP;
    p[lane] = st.b1[j];
    p[KP + lane] = st.b2[j];
    p[2 * KP + lane] = __int_as_float(st.a1[j]);
    p[3 * KP + lane] = __int_as_float(st.a2[j]);
  }
}

// The int8 visit scan on mma.sync (see the design above).
namespace mm {

using namespace winmin;

constexpr int WARPS = KP / 16;            // one m16 tile of lane windows a warp
constexpr int THREADS = 32 * WARPS;
constexpr int NT = QTK / 8;               // n8 tiles: all the visit's queries
constexpr int KS = D / 32;                // k32 steps of a row
constexpr int SLABS = CHK / KP;           // slabs a chunk step
constexpr int NBUF = 4;                   // ring of slabs: 3 in flight
constexpr int PITCH = D + 16;             // staged row pitch, bytes
constexpr int SLAB_BYTES = KP * PITCH;
constexpr int RING_BYTES = NBUF * SLAB_BYTES;
constexpr int RN_BYTES = NBUF * KP * 4;
constexpr int BQ_BYTES = NT * KS * 32 * 8;  // [nt][kk][lane] (b0, b1)
constexpr int STG_PITCH = 4 * KP + 4;     // floats a query row of the staged state
constexpr int SMEM = RING_BYTES + RN_BYTES + BQ_BYTES;
constexpr int NP = 4 * NT;                // (lane window, query) pairs a thread
static_assert(KP * D / 16 % THREADS == 0, "whole 16-byte copies a thread");
static_assert(QTK * STG_PITCH * 4 <= RING_BYTES, "the state transpose fits the ring");

// Best / second-best ladder of one pair: strict '<', earlier rows win ties.
__device__ __forceinline__ void ladder(float s, int cand, float& b1, int& a1, float& b2,
                                       int& a2) {
  if (s < b2) {
    if (s < b1) {
      b2 = b1;
      a2 = a1;
      b1 = s;
      a1 = cand;
    } else {
      b2 = s;
      a2 = cand;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
int8_scan_kernel(const int* __restrict__ step_chunk, const int* __restrict__ vfirst,
                 const int* __restrict__ vcount, const int8_t* __restrict__ qsteps,
                 const int8_t* __restrict__ codes, const float* __restrict__ rn,
                 float* __restrict__ out, float ratio2) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                          // [NBUF][KP][PITCH]
  float* rns = reinterpret_cast<float*>(smem + RING_BYTES);            // [NBUF][KP]
  uint2* bqs = reinterpret_cast<uint2*>(smem + RING_BYTES + RN_BYTES);  // [NT][KS][32]

  const int visit = blockIdx.x;
  const int first = vfirst[visit];
  const int total = vcount[visit] * SLABS;  // the visit's slabs, steps in order
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const unsigned ring_s = smem_addr(ring), rns_s = smem_addr(rns);

  auto issue = [&](int i) {  // slab i of the visit (rows and norms) into buffer i % NBUF
    if (i < total) {
      const size_t row0 = (size_t)__ldg(step_chunk + first + i / SLABS) * CHK + (i % SLABS) * KP;
      const int8_t* src = codes + row0 * D;
      const unsigned dst = ring_s + (i % NBUF) * SLAB_BYTES;
#pragma unroll
      for (int k = 0; k < KP * D / 16 / THREADS; ++k) {
        const int j = tid + k * THREADS, r = j >> 3, c = j & 7;
        cp_async16(dst + r * PITCH + 16 * c, src + r * D + 16 * c);
      }
      if (tid < KP / 4) cp_async16(rns_s + (i % NBUF) * KP * 4 + 16 * tid, rn + row0 + 4 * tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NBUF - 1; ++i) issue(i);

  {  // the visit's queries as B fragments: query nt*8 + g, bytes 32kk + 4t, 32kk + 16 + 4t
    const int* qv = reinterpret_cast<const int*>(qsteps + (size_t)visit * QTK * D);
    for (int e = tid; e < NT * KS * 32; e += THREADS) {
      const int l = e & 31, nt = (e >> 5) / KS, kk = (e >> 5) % KS;
      const int* qrow = qv + (nt * 8 + (l >> 2)) * (D / 4);
      bqs[e] = make_uint2(qrow[8 * kk + (l & 3)], qrow[8 * kk + 4 + (l & 3)]);
    }
  }

  // pair j = (2 nt + e) * 2 + h: lane window 16 warp + g + 8h, query 8 nt + 2t + e
  float b1[NP], b2[NP];
  int a1[NP], a2[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    b1[j] = b2[j] = BIG;
    a1[j] = a2[j] = 0;
  }
  const int rbase = warp * 16;
  const unsigned lm_off = ldmatrix_offset(lane, PITCH) + rbase * PITCH;

  for (int i = 0; i < total; ++i) {
    cp_async_wait<NBUF - 2>();
    // slab i has arrived, the B fragments are staged, and every read of
    // buffer (i - 1) % NBUF is done
    __syncthreads();
    issue(i + NBUF - 1);
    const int buf = i % NBUF;
    int acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, ring_s + buf * SLAB_BYTES + lm_off + 32 * kk);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = bqs[(nt * KS + kk) * 32 + lane];
        mma_s8(acc[nt], a, b.x, b.y);
      }
    }
    const float rn0 = rns[buf * KP + rbase + g], rn1 = rns[buf * KP + rbase + g + 8];
    const int cand = __ldg(step_chunk + first + i / SLABS) * CHK + (i % SLABS) * KP + rbase + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // query 8 nt + 2t + e: row g, then row g + 8
        const int j = (2 * nt + e) * 2;
        ladder(score(acc[nt][e], rn0, ratio2), cand, b1[j], a1[j], b2[j], a2[j]);
        ladder(score(acc[nt][2 + e], rn1, ratio2), cand + 8, b1[j + 1], a1[j + 1], b2[j + 1],
               a2[j + 1]);
      }
  }

  // The packed state [QTK][vals | vals2 | args | args2] through shared
  // memory (the ring is free: every copy landed and every slab was read).
  // A row pitch of 4 KP + 4 floats puts the four queries of a store on
  // distinct banks.
  cp_async_wait<0>();
  __syncthreads();
  float* stg = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = (2 * nt + e) * 2 + h;
        float* p = stg + (8 * nt + 2 * t + e) * STG_PITCH + rbase + g + 8 * h;
        p[0] = b1[j];
        p[KP] = b2[j];
        p[2 * KP] = __int_as_float(a1[j]);
        p[3 * KP] = __int_as_float(a2[j]);
      }
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out + (size_t)visit * QTK * 4 * KP);
  for (int e = tid; e < QTK * KP; e += THREADS)
    o[e] = *reinterpret_cast<const float4*>(stg + (e / KP) * STG_PITCH + 4 * (e % KP));
}

}  // namespace mm

template <int M>
__global__ void __launch_bounds__(THREADS)
pq_scan_kernel(const int* __restrict__ step_chunk, const int* __restrict__ vfirst,
               const int* __restrict__ vcount, const int8_t* __restrict__ qsteps,
               const int* __restrict__ packed, const float* __restrict__ rn,
               const int8_t* __restrict__ cent, float* __restrict__ out, float ratio2,
               int ksub) {
  __shared__ int4 qs[QTK * V];
  extern __shared__ int cb[];  // [M * ksub][32 / M] words
  const int visit = blockIdx.x;
  stage_queries(qsteps, visit, qs);
  const int* cent_w = reinterpret_cast<const int*>(cent);
  for (int i = threadIdx.x; i < ksub * (winmin::D / 4); i += THREADS) cb[i] = cent_w[i];
  __syncthreads();
  State st;
  const PqRows<M> rows{packed, cb, ksub};
  scan_visit(rows, step_chunk, vfirst[visit], vcount[visit], rn, qs, ratio2, st);
  store_state(out, visit, st);
}

__device__ __forceinline__ void insert_sorted(float (&sv)[FS], int (&si)[FS], float cv, int ci) {
#pragma unroll
  for (int j = 0; j < FS; ++j) {
    if (cv < sv[j]) {
      const float tv = sv[j];
      const int ti = si[j];
      sv[j] = cv;
      si[j] = ci;
      cv = tv;
      ci = ti;
    }
  }
}

// Thread (query, lane): the query's visit rows in ascending visit id
// (order[qstart[q] .. + qcount[q]]), best then second-best of each, into
// FS ascending slots; rows from nq on get the initial (BIG, 0).
__global__ void __launch_bounds__(KP * FOLD_Q)
fold_kernel(const float* __restrict__ states, const int* __restrict__ order,
            const int* __restrict__ qstart, const int* __restrict__ qcount,
            float* __restrict__ facc, int nq, int rows) {
  const int q = blockIdx.x * FOLD_Q + threadIdx.x / KP;
  const int lane = threadIdx.x % KP;
  if (q >= rows) return;
  float sv[FS];
  int si[FS];
#pragma unroll
  for (int j = 0; j < FS; ++j) {
    sv[j] = BIG;
    si[j] = 0;
  }
  if (q < nq) {
    const int e0 = qstart[q];
    const int e1 = e0 + qcount[q];
    for (int e = e0; e < e1; ++e) {
      const float* p = states + (size_t)order[e] * 4 * KP;
      insert_sorted(sv, si, p[lane], __float_as_int(p[2 * KP + lane]));
      insert_sorted(sv, si, p[KP + lane], __float_as_int(p[3 * KP + lane]));
    }
  }
  float* o = facc + (size_t)q * 2 * FS * KP;
#pragma unroll
  for (int j = 0; j < FS; ++j) {
    o[j * KP + lane] = sv[j];
    o[(FS + j) * KP + lane] = __int_as_float(si[j]);
  }
}

int launch_pq(const void* step_chunk, const void* vfirst, const void* vcount,
              const void* qsteps, const void* packed, const void* rn, const void* cent,
              void* out, int n_visits, float ratio2, int m, int ksub, cudaStream_t s) {
  if (n_visits <= 0) return 0;
  const size_t smem = (size_t)ksub * winmin::D;  // <= 32 KB: no opt-in needed
  const auto sc = static_cast<const int*>(step_chunk);
  const auto vf = static_cast<const int*>(vfirst);
  const auto vc = static_cast<const int*>(vcount);
  const auto q = static_cast<const int8_t*>(qsteps);
  const auto pk = static_cast<const int*>(packed);
  const auto r = static_cast<const float*>(rn);
  const auto c = static_cast<const int8_t*>(cent);
  const auto o = static_cast<float*>(out);
  switch (m) {
    case 4: pq_scan_kernel<4><<<n_visits, THREADS, smem, s>>>(sc, vf, vc, q, pk, r, c, o, ratio2, ksub); break;
    case 8: pq_scan_kernel<8><<<n_visits, THREADS, smem, s>>>(sc, vf, vc, q, pk, r, c, o, ratio2, ksub); break;
    case 16: pq_scan_kernel<16><<<n_visits, THREADS, smem, s>>>(sc, vf, vc, q, pk, r, c, o, ratio2, ksub); break;
    case 32: pq_scan_kernel<32><<<n_visits, THREADS, smem, s>>>(sc, vf, vc, q, pk, r, c, o, ratio2, ksub); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_fold(const void* states, const void* order, const void* qstart, const void* qcount,
                void* facc, int nq, int rows, cudaStream_t s) {
  fold_kernel<<<(rows + FOLD_Q - 1) / FOLD_Q, KP * FOLD_Q, 0, s>>>(
      static_cast<const float*>(states), static_cast<const int*>(order),
      static_cast<const int*>(qstart), static_cast<const int*>(qcount),
      static_cast<float*>(facc), nq, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// step_chunk [S] int32, vfirst / vcount [V] int32 (each visit's first step
// and step count), qsteps [V, 32, 128] int8, codes [n_chunks, 2048, 128] int8,
// rn [n_chunks, 2048] fp32, codes and rn 16-byte aligned -> out [V, 32, 512]
// fp32 packed states.
extern "C" int ivf_chunk_int8(const void* step_chunk, const void* vfirst, const void* vcount,
                              const void* qsteps, const void* codes, const void* rn,
                              void* out, int n_visits, float ratio2, void* stream) {
  if (n_visits <= 0) return 0;
  static_assert(mm::SMEM <= 227 * 1024, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      mm::int8_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, mm::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  mm::int8_scan_kernel<<<n_visits, mm::THREADS, mm::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(step_chunk), static_cast<const int*>(vfirst),
      static_cast<const int*>(vcount), static_cast<const int8_t*>(qsteps),
      static_cast<const int8_t*>(codes), static_cast<const float*>(rn),
      static_cast<float*>(out), ratio2);
  return static_cast<int>(cudaGetLastError());
}

// As ivf_chunk_int8 into scratch [V, 32, 512], then the fold into facc
// [rows, 2 * 4 * 128]: order / qstart / qcount list each query's visit rows
// (flat visit * 32 + row) in ascending visit id.
extern "C" int ivf_chunk_int8_fold(const void* step_chunk, const void* vfirst,
                                   const void* vcount, const void* qsteps, const void* codes,
                                   const void* rn, const void* order, const void* qstart,
                                   const void* qcount, void* scratch, void* facc,
                                   int n_visits, int nq, int rows, float ratio2,
                                   void* stream) {
  const int err = ivf_chunk_int8(step_chunk, vfirst, vcount, qsteps, codes, rn, scratch,
                                 n_visits, ratio2, stream);
  if (err != 0) return err;
  return launch_fold(scratch, order, qstart, qcount, facc, nq, rows,
                     static_cast<cudaStream_t>(stream));
}

// packed [n_chunks, ceil(m / 4), 2048] int32, cent [m * ksub, 128 / m] int8
// (m in 4, 8, 16, 32; ksub <= 256); the rest as ivf_chunk_int8.
extern "C" int ivf_chunk_pq(const void* step_chunk, const void* vfirst, const void* vcount,
                            const void* qsteps, const void* packed, const void* rn,
                            const void* cent, void* out, int n_visits, float ratio2, int m,
                            int ksub, void* stream) {
  return launch_pq(step_chunk, vfirst, vcount, qsteps, packed, rn, cent, out, n_visits,
                   ratio2, m, ksub, static_cast<cudaStream_t>(stream));
}

extern "C" int ivf_chunk_pq_fold(const void* step_chunk, const void* vfirst,
                                 const void* vcount, const void* qsteps, const void* packed,
                                 const void* rn, const void* cent, const void* order,
                                 const void* qstart, const void* qcount, void* scratch,
                                 void* facc, int n_visits, int nq, int rows, float ratio2,
                                 int m, int ksub, void* stream) {
  const int err = launch_pq(step_chunk, vfirst, vcount, qsteps, packed, rn, cent, scratch,
                            n_visits, ratio2, m, ksub, static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return launch_fold(scratch, order, qstart, qcount, facc, nq, rows,
                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* ivf_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
