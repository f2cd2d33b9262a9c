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
// What bounds it on an H100: device memory.  An int8 chunk step reads 2048
// rows x (128 B + 4 B norm) and does 32 x 2048 x 128 x 2 int8 operations,
// ~62 operations per byte, far below the card's ~590 int8 operations per
// byte of bandwidth: the int8 scan has to stream bytes, not add math.  A PQ
// row is 8 B of codes at m = 8, so there the 64 KB state a visit writes
// leads the bytes, and the rebuild and the products the work.
//
// Design: the TPU runs one grid step per (visit, chunk) and carries the
// visit's state across steps in VMEM scratch, folding into a VMEM-resident
// accumulator at each visit's last step.  Hopper blocks run in no order, so
// one block per visit walks that visit's chunk steps in order (the
// sequential grid becomes a loop, so a visit's steps are serial: the
// engine cuts the plan's padding steps, all of one pad visit over the
// empty dump chunk, before it launches).
//  - Both scans: a chunk step is 16 slabs of KP = 128 rows, and slab row p
//    is lane window p.  Each slab is staged in shared memory at a 144-byte
//    pitch, one barrier a slab.  Warp w owns slab rows 16w .. 16w+15 (one
//    m16 tile) for all 32 queries (four n8 tiles): per slab 4 k32 steps x 4
//    n-tiles = 16 int8 mma.sync m16n8k32, A fragments by ldmatrix, the
//    visit's B fragments staged once in shared memory in fragment order.  A
//    thread's 16 accumulators map to the same (lane window, query) pairs in
//    every slab, so its best / second-best ladders live in registers and see
//    their rows in ascending order: the strict '<' gives the TPU's tie rule
//    with no cross-thread merge.  The common ladder update is one compare
//    against the second-best.  At the visit's end the 64 KB state goes out
//    through a shared-memory transpose (over the idle staging) as 16-byte
//    stores.  These parts are the device functions below.
//  - The int8 scan (ivf_chunk_int8) copies its rows: the slabs of all the
//    visit's steps arrive in order by cp.async (rows with their 128 norms)
//    into a ring of four slabs, three ahead of the one being scored.
//  - The PQ scan (ivf_chunk_pq) rebuilds them: the int8 codebook (ksub x
//    128 B) is staged in shared memory once a visit; each slab's codes
//    (ceil(m/4) planes x 512 B) and its 128 norms arrive by cp.async in a
//    ring of four, crossing step boundaries.  Two threads rebuild each slab
//    row (64 B each, as 16-byte shared stores) into a double-buffered staged
//    slab: the rebuild of slab i+1 and the products of slab i sit between
//    the same two barriers.  The norms of the rebuilt rows come in with the
//    codes (rn), so there is no norm pass.
//  - The fold runs as a second kernel over the packed per-visit states:
//    thread (query, lane) walks the query's visit rows in ascending visit
//    id (an index the wrapper sorts) and inserts.  A single-pass fold that
//    inserted visits as blocks finish would order ties by block timing; two
//    passes cost the [V, QTK, 4 KP] buffer the TPU kept out of HBM.
#include "winmin.cuh"

namespace {

using namespace winmin;

constexpr int QTK = 32;               // queries per visit
constexpr int KP = 128;               // lane windows per visit
constexpr int CHK = 2048;             // rows per chunk
constexpr int FS = 4;                 // fold slots per window
constexpr int FOLD_Q = 2;             // queries per fold block

constexpr int WARPS = KP / 16;            // one m16 tile of lane windows a warp
constexpr int THREADS = 32 * WARPS;
constexpr int NT = QTK / 8;               // n8 tiles: all the visit's queries
constexpr int KS = D / 32;                // k32 steps of a row
constexpr int SLABS = CHK / KP;           // slabs a chunk step
constexpr int NBUF = 4;                   // ring of slabs (int8) or codes (PQ): 3 in flight
constexpr int PITCH = D + 16;             // staged row pitch, bytes
constexpr int SLAB_BYTES = KP * PITCH;
constexpr int RN_BYTES = NBUF * KP * 4;
constexpr int BQ_BYTES = NT * KS * 32 * 8;  // [nt][kk][lane] (b0, b1)
constexpr int STG_PITCH = 4 * KP + 4;     // floats a query row of the staged state
constexpr int STG_BYTES = QTK * STG_PITCH * 4;
constexpr int NP = 4 * NT;                // (lane window, query) pairs a thread

// pair j = (2 nt + e) * 2 + h: lane window 16 warp + g + 8h, query 8 nt + 2t + e
struct Ladders {
  float b1[NP], b2[NP];
  int a1[NP], a2[NP];
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      b1[j] = b2[j] = BIG;
      a1[j] = a2[j] = 0;
    }
  }
};

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

// The visit's queries as B fragments into bqs [NT][KS][32]: query nt*8 + g,
// bytes 32kk + 4t and 32kk + 16 + 4t.
__device__ __forceinline__ void stage_queries(const int8_t* qsteps, int visit, uint2* bqs) {
  const int* qv = reinterpret_cast<const int*>(qsteps + (size_t)visit * QTK * D);
  for (int e = threadIdx.x; e < NT * KS * 32; e += THREADS) {
    const int l = e & 31, nt = (e >> 5) / KS, kk = (e >> 5) % KS;
    const int* qrow = qv + (nt * 8 + (l >> 2)) * (D / 4);
    bqs[e] = make_uint2(qrow[8 * kk + (l & 3)], qrow[8 * kk + 4 + (l & 3)]);
  }
}

// Score this warp's 16 rows of a staged slab (a_s: the shared address of
// this lane's ldmatrix row; rns: the norms of the warp's rows; cand_of():
// the id of the warp's row g) against the visit's queries, into the ladders.
// The id is read after the products: read before them, it cost the int8
// scan 1-4% on an H100.
template <class Cand>
__device__ __forceinline__ void scan_slab(unsigned a_s, const uint2* bqs, const float* rns,
                                          Cand cand_of, float ratio2, int lane, Ladders& L) {
  const int g = lane >> 2;
  int acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    unsigned a[4];
    ldmatrix_x4(a, a_s + 32 * kk);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = bqs[(nt * KS + kk) * 32 + lane];
      mma_s8(acc[nt], a, b.x, b.y);
    }
  }
  const float rn0 = rns[g], rn1 = rns[g + 8];
  const int cand = cand_of();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // query 8 nt + 2t + e: row g, then row g + 8
      const int j = (2 * nt + e) * 2;
      ladder(score(acc[nt][e], rn0, ratio2), cand, L.b1[j], L.a1[j], L.b2[j], L.a2[j]);
      ladder(score(acc[nt][2 + e], rn1, ratio2), cand + 8, L.b1[j + 1], L.a1[j + 1],
             L.b2[j + 1], L.a2[j + 1]);
    }
}

// The packed state [QTK][vals | vals2 | args | args2] of the visit through
// stg (STG_BYTES of idle shared memory; the caller's barrier has retired
// every read of it).  A row pitch of 4 KP + 4 floats puts the four queries
// of a store on distinct banks.
__device__ __forceinline__ void store_state(const Ladders& L, float* stg, float* out,
                                            int visit) {
  const int lane = threadIdx.x & 31, rbase = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = (2 * nt + e) * 2 + h;
        float* p = stg + (8 * nt + 2 * t + e) * STG_PITCH + rbase + g + 8 * h;
        p[0] = L.b1[j];
        p[KP] = L.b2[j];
        p[2 * KP] = __int_as_float(L.a1[j]);
        p[3 * KP] = __int_as_float(L.a2[j]);
      }
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out + (size_t)visit * QTK * 4 * KP);
  for (int e = threadIdx.x; e < QTK * KP; e += THREADS)
    o[e] = *reinterpret_cast<const float4*>(stg + (e / KP) * STG_PITCH + 4 * (e % KP));
}

// The int8 visit scan: rows copied into the slab ring.
constexpr int RING_BYTES = NBUF * SLAB_BYTES;
constexpr int INT8_SMEM = RING_BYTES + RN_BYTES + BQ_BYTES;
static_assert(KP * D / 16 % THREADS == 0, "whole 16-byte copies a thread");
static_assert(STG_BYTES <= RING_BYTES, "the state transpose fits the ring");

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
  const int g = lane >> 2;
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
  stage_queries(qsteps, visit, bqs);

  Ladders L;
  L.reset();
  const int rbase = warp * 16;
  const unsigned lm_off = ldmatrix_offset(lane, PITCH) + rbase * PITCH;

  for (int i = 0; i < total; ++i) {
    cp_async_wait<NBUF - 2>();
    // slab i has arrived, the B fragments are staged, and every read of
    // buffer (i - 1) % NBUF is done
    __syncthreads();
    issue(i + NBUF - 1);
    const int buf = i % NBUF;
    const auto cand_of = [&] {
      return __ldg(step_chunk + first + i / SLABS) * CHK + (i % SLABS) * KP + rbase + g;
    };
    scan_slab(ring_s + buf * SLAB_BYTES + lm_off, bqs, rns + buf * KP + rbase, cand_of, ratio2,
              lane, L);
  }
  // the ring is free: every copy landed and every slab was read
  cp_async_wait<0>();
  __syncthreads();
  store_state(L, reinterpret_cast<float*>(ring), out, visit);
}

// The PQ visit scan: rows rebuilt from codes through the staged codebook.
// packed [n_chunks][MP][CHK] int32, code j in byte j % 4 of word j / 4;
// cent is the int8 codebook [M * ksub][128 / M].
constexpr int PQ_FIXED = 2 * SLAB_BYTES + BQ_BYTES + RN_BYTES;  // then codes, codebook
static_assert(THREADS == 2 * KP, "two threads rebuild each slab row");

template <int M>
__host__ __device__ constexpr int pq_codes_bytes() {
  return NBUF * ((M + 3) / 4) * KP * 4;
}

template <int M>
__global__ void __launch_bounds__(THREADS, 2)
pq_scan_kernel(const int* __restrict__ step_chunk, const int* __restrict__ vfirst,
               const int* __restrict__ vcount, const int8_t* __restrict__ qsteps,
               const int* __restrict__ packed, const float* __restrict__ rn,
               const int8_t* __restrict__ cent, float* __restrict__ out, float ratio2,
               int ksub) {
  static_assert(M >= 1 && M <= D && D % M == 0, "m divides 128");
  constexpr int MP = (M + 3) / 4;     // code words (planes) a row
  constexpr int DSUB = D / M;         // codebook bytes an entry
  constexpr int JH = M / 2;           // subspaces a half row (0 at M = 1: one spans both)
  constexpr int CODE_COPIES = MP * KP / 4;  // 16-byte codes copies a slab
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* slabs = smem;                                         // [2][KP][PITCH]
  uint2* bqs = reinterpret_cast<uint2*>(smem + 2 * SLAB_BYTES);         // [NT][KS][32]
  float* rns = reinterpret_cast<float*>(smem + 2 * SLAB_BYTES + BQ_BYTES);  // [NBUF][KP]
  int* cds = reinterpret_cast<int*>(smem + PQ_FIXED);                  // [NBUF][MP][KP]
  const unsigned char* cb = smem + PQ_FIXED + pq_codes_bytes<M>();     // [M ksub][DSUB]

  const int visit = blockIdx.x;
  const int first = vfirst[visit];
  const int total = vcount[visit] * SLABS;  // the visit's slabs, steps in order
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;
  const unsigned slabs_s = smem_addr(slabs), rns_s = smem_addr(rns), cds_s = smem_addr(cds);

  auto issue = [&](int i) {  // slab i's codes and norms into slot i % NBUF
    if (i < total) {
      const int chunk = __ldg(step_chunk + first + i / SLABS);
      const int off = (i % SLABS) * KP, slot = i % NBUF;
      auto copy = [&](int e) {
        const int p = e / (KP / 4), c = e % (KP / 4);
        cp_async16(cds_s + ((slot * MP + p) * KP + 4 * c) * 4,
                   packed + ((size_t)chunk * MP + p) * CHK + off + 4 * c);
      };
      if constexpr (CODE_COPIES <= THREADS) {
        if (tid < CODE_COPIES) copy(tid);
      } else {  // m 64, 128: 16 or 32 planes
        for (int e = tid; e < CODE_COPIES; e += THREADS) copy(e);
      }
      if (tid >= THREADS - KP / 4) {
        const int c = tid - (THREADS - KP / 4);
        cp_async16(rns_s + (slot * KP + 4 * c) * 4, rn + (size_t)chunk * CHK + off + 4 * c);
      }
    }
    cp_async_commit();
  };

  // Rebuild slab i into buffer i & 1: thread tid writes bytes 64h .. 64h+63
  // (subspaces JH h .. JH h + JH - 1; at M = 1 half h of the one entry) of
  // row r as four 16-byte stores.
  const int r = tid >> 1, h = tid & 1;
  const unsigned char* cbh = cb + h * JH * ksub * DSUB;  // the half's first entry
  auto rebuild = [&](int i) {
    const int* rc = cds + (i % NBUF) * MP * KP + r;
    int4* dst = reinterpret_cast<int4*>(slabs + ((i & 1) * KP + r) * PITCH + 64 * h);
    if constexpr (M == 1) {  // one 128-byte entry: this half's 64 bytes of it
      const int4* e = reinterpret_cast<const int4*>(cb + (rc[0] & 255) * D + 64 * h);
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[c] = e[c];
    } else {
      constexpr int NW = (JH + 3) / 4;
      unsigned words[NW];  // the half's codes, subspace jj in byte jj % 4 of word jj / 4
      if constexpr (JH < 4) {  // M 2, 4: both halves' codes in word 0
        words[0] = static_cast<unsigned>(rc[0]) >> (8 * JH * h);
      } else {
#pragma unroll
        for (int u = 0; u < NW; ++u) words[u] = rc[(h * NW + u) * KP];
      }
      // the half's subspace jj: its entry's first byte
      auto entry = [&](int jj) {
        return cbh + (jj * ksub + ((words[jj / 4] >> (8 * (jj % 4))) & 255)) * DSUB;
      };
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int4 v;
        if constexpr (DSUB >= 16) {  // the piece lies in one entry
          v = *reinterpret_cast<const int4*>(entry(16 * c / DSUB) + (16 * c) % DSUB);
        } else if constexpr (DSUB == 8) {
          const int2 lo = *reinterpret_cast<const int2*>(entry(2 * c));
          const int2 hi = *reinterpret_cast<const int2*>(entry(2 * c + 1));
          v = make_int4(lo.x, lo.y, hi.x, hi.y);
        } else if constexpr (DSUB == 4) {
          v = make_int4(*reinterpret_cast<const int*>(entry(4 * c)),
                        *reinterpret_cast<const int*>(entry(4 * c + 1)),
                        *reinterpret_cast<const int*>(entry(4 * c + 2)),
                        *reinterpret_cast<const int*>(entry(4 * c + 3)));
        } else {  // DSUB 2 or 1: an entry is part of a word
          constexpr int PER = 4 / DSUB;  // entries a word
          int w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            unsigned x = 0;
#pragma unroll
            for (int e = 0; e < PER; ++e) {
              const unsigned char* p = entry((4 * c + k) * PER + e);
              const unsigned piece =
                  DSUB == 2 ? *reinterpret_cast<const unsigned short*>(p) : *p;
              x |= piece << (8 * DSUB * e);
            }
            w[k] = static_cast<int>(x);
          }
          v = make_int4(w[0], w[1], w[2], w[3]);
        }
        dst[c] = v;
      }
    }
  };

  Ladders L;
  L.reset();
  if (total > 0) {
    {  // the codebook, in the first slab's copy group
      const unsigned cb_s = smem_addr(smem + PQ_FIXED + pq_codes_bytes<M>());
      for (int e = tid; e < ksub * (D / 16); e += THREADS) cp_async16(cb_s + 16 * e, cent + 16 * e);
    }
#pragma unroll
    for (int i = 0; i < NBUF - 1; ++i) issue(i);
    stage_queries(qsteps, visit, bqs);
    cp_async_wait<NBUF - 2>();
    __syncthreads();  // the codebook and slab 0's codes have arrived
    rebuild(0);

    const int rbase = warp * 16;
    const unsigned lm_off = ldmatrix_offset(lane, PITCH) + rbase * PITCH;
    for (int i = 0; i < total; ++i) {
      cp_async_wait<NBUF - 3>();
      // slab i is rebuilt, slab i+1's codes and slab i's norms have
      // arrived, and every read of buffer (i+1) & 1 and of slot (i-1) % NBUF
      // is done
      __syncthreads();
      issue(i + NBUF - 1);
      if (i + 1 < total) rebuild(i + 1);
      const auto cand_of = [&] {
        return __ldg(step_chunk + first + i / SLABS) * CHK + (i % SLABS) * KP + rbase + g;
      };
      scan_slab(slabs_s + (i & 1) * SLAB_BYTES + lm_off, bqs, rns + (i % NBUF) * KP + rbase,
                cand_of, ratio2, lane, L);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every read of the staging is done
  store_state(L, reinterpret_cast<float*>(smem), out, visit);
}

template <int M>
size_t pq_smem(int ksub) {
  const size_t scan = PQ_FIXED + pq_codes_bytes<M>() + (size_t)ksub * D;
  return scan > STG_BYTES ? scan : STG_BYTES;
}
static_assert(PQ_FIXED + pq_codes_bytes<128>() + 256 * D <= 227 * 1024, "shared memory");

template <int M>
int launch_pq_m(const int* sc, const int* vf, const int* vc, const int8_t* q, const int* pk,
                const float* r, const int8_t* c, float* o, int n_visits, float ratio2,
                int ksub, cudaStream_t s) {
  const size_t smem = pq_smem<M>(ksub);
  cudaError_t err = cudaFuncSetAttribute(
      pq_scan_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pq_scan_kernel<M><<<n_visits, THREADS, smem, s>>>(sc, vf, vc, q, pk, r, c, o, ratio2, ksub);
  return static_cast<int>(cudaGetLastError());
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
  const auto sc = static_cast<const int*>(step_chunk);
  const auto vf = static_cast<const int*>(vfirst);
  const auto vc = static_cast<const int*>(vcount);
  const auto q = static_cast<const int8_t*>(qsteps);
  const auto pk = static_cast<const int*>(packed);
  const auto r = static_cast<const float*>(rn);
  const auto c = static_cast<const int8_t*>(cent);
  const auto o = static_cast<float*>(out);
  switch (m) {
    case 1: return launch_pq_m<1>(sc, vf, vc, q, pk, r, c, o, n_visits, ratio2, ksub, s);
    case 2: return launch_pq_m<2>(sc, vf, vc, q, pk, r, c, o, n_visits, ratio2, ksub, s);
    case 4: return launch_pq_m<4>(sc, vf, vc, q, pk, r, c, o, n_visits, ratio2, ksub, s);
    case 8: return launch_pq_m<8>(sc, vf, vc, q, pk, r, c, o, n_visits, ratio2, ksub, s);
    case 16: return launch_pq_m<16>(sc, vf, vc, q, pk, r, c, o, n_visits, ratio2, ksub, s);
    case 32: return launch_pq_m<32>(sc, vf, vc, q, pk, r, c, o, n_visits, ratio2, ksub, s);
    case 64: return launch_pq_m<64>(sc, vf, vc, q, pk, r, c, o, n_visits, ratio2, ksub, s);
    case 128: return launch_pq_m<128>(sc, vf, vc, q, pk, r, c, o, n_visits, ratio2, ksub, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  static_assert(INT8_SMEM <= 227 * 1024, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      int8_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, INT8_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_scan_kernel<<<n_visits, THREADS, INT8_SMEM, static_cast<cudaStream_t>(stream)>>>(
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
// (m dividing 128; ksub <= 256), packed, rn and cent 16-byte aligned;
// the rest as ivf_chunk_int8.
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

// The fold pass alone over packed states [V, 32, 512] (as the fold scans
// run it after their scan).
extern "C" int ivf_fold(const void* states, const void* order, const void* qstart,
                        const void* qcount, void* facc, int nq, int rows, void* stream) {
  return launch_fold(states, order, qstart, qcount, facc, nq, rows,
                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* ivf_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
