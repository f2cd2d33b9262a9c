// Fused PQ scan: rebuild every row from its PQ codes through the int8
// codebook, score it against every query and keep only the (min, lowest
// argmin) of each window of W rows.
//
// Replaces deepreadmapper_tpu/ops/scan_kernel.py::_pq_kernel (driven by
// _pq_winmin_call / fused_scan_topk(kind="pq")), the PQFLAT engine's scan
// at N >= 2^18 rows.
//
// The rebuilt row is exactly int8-valued (cent8[j][code_j] for each of the
// m subspaces), so the score is the int8 scan's: s = rn - ratio2 * (q . r)
// with rn the squared norm of the rebuilt row, rows at or past ntotal
// masked to 3.4e38, rounded once as an FMA (see int8_winmin.cu).
// |q . r| <= 128 x 127^2 < 2^22, so the int32 sum converts to fp32 exactly.
//
// What bounds it on an H100: int8 operations.  2^18 rows x 8192 queries x
// 128 x 2 is 5.5e11, 0.278 ms at the tensor cores' 1,979 TOP/s (dense); the
// codes are 8 B a row at m = 8, so device memory traffic is small.  On
// __dp4a (int8_winmin.cu's scan) the same work runs at about 95 TOP/s, some
// 70% of what dp4a issues; only the tensor cores go further.
//
// Design: the TPU kernel rebuilds a [128, 4096] tile per grid step with
// one-hot x block-diagonal-codebook matmuls on the MXU.  Here a block of 8
// warps owns 128 queries and WPB = 32 consecutive windows (enough to
// amortise staging the codebook and the queries), and walks their rows in
// 128-row slabs:
//  - The int8 codebook (ksub x 128 B, at most 32 KB) is staged in shared
//    memory once.  The slab's codes arrive by cp.async two slabs ahead; two
//    threads rebuild each row of the slab (64 B each, as 16-byte shared
//    stores), and sum its exact norm with __dp4a on the rebuilt words.  The
//    kernel is compiled for each m: a 16-byte piece of a row is one
//    codebook entry's load (m <= 8), two or four (m 16, 32), or at m 64 and
//    128, where an entry is 2 or 1 bytes, 8 or 16 entries packed into
//    words after one load of the piece's codes.
//  - The slab is double-buffered: the rebuild of slab i+1 and the products
//    of slab i sit between the same two barriers, one barrier a slab.
//  - Scores, the (min, row) fold and the window combine are the scan
//    block of winmin.cuh (int8 mma.sync m16n8k32, 2 x 4 warp tiles of 64
//    rows x 32 queries), shared with int8_winmin.cu.  The per-score fold, a
//    handful of instructions for every score, costs more than the products.
#include "winmin.cuh"

namespace {

using namespace winmin;
using namespace winmin::scan;

constexpr int CB_BYTES_MAX = 256 * D;  // ksub <= 256 entries of 128 B
constexpr int M_MAX = 128;            // 128 / m bytes an entry, down to 1
static_assert(THREADS == 2 * SLAB, "two threads rebuild each slab row");

constexpr size_t SLAB_BYTES = 2 * SLAB * PITCH;  // double-buffered
constexpr size_t RN_BYTES = 2 * SLAB * 4;

template <int M>
__global__ void __launch_bounds__(THREADS, 2)
pq_winmin_kernel(const int8_t* __restrict__ q8, const uint8_t* __restrict__ codes,
                 const int8_t* __restrict__ cent8, float* __restrict__ vals,
                 int* __restrict__ args, int qp, int nwin, int w, int ntotal,
                 float ratio2, int ksub) {
  static_assert(M >= 1 && M <= M_MAX && D % M == 0, "m divides 128");
  constexpr int DSUB = D / M;                 // codebook bytes an entry
  constexpr int CODE_COPIES = SLAB * M / 16;  // 16-byte codes copies a slab
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* slab = smem;                                 // [2][SLAB][PITCH]
  float* redv = reinterpret_cast<float*>(smem + SLAB_BYTES);  // [2][2][QB]
  int* redr = reinterpret_cast<int*>(redv + 2 * 2 * QB);      // [2][2][QB]
  float* rn = reinterpret_cast<float*>(redr + 2 * 2 * QB);    // [2][SLAB]
  unsigned char* cb = reinterpret_cast<unsigned char*>(rn + 2 * SLAB);  // [M ksub][DSUB]
  uint8_t* cds = cb + ksub * D;                               // [2][SLAB][M]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 2, wq = warp & 3;
  const int spw = w / SLAB;  // slabs a window
  const int win0 = blockIdx.y * WPB;
  const int nslab = (min(win0 + WPB, nwin) - win0) * spw;
  const int row_first = win0 * w;
  const int qbase = blockIdx.x * QB;

  auto issue_codes = [&](int s) {  // codes of local slab s into slot s & 1
    if (s < nslab)
      for (int e = tid; e < CODE_COPIES; e += THREADS)
        cp_async16(smem_addr(cds + (s & 1) * SLAB * M + 16 * e),
                   codes + ((size_t)row_first + (size_t)s * SLAB) * M + 16 * e);
    cp_async_commit();
  };
  issue_codes(0);
  issue_codes(1);

  {  // the codebook, once
    const int4* src = reinterpret_cast<const int4*>(cent8);
    int4* dst = reinterpret_cast<int4*>(cb);
    for (int i = tid; i < ksub * D / 16; i += THREADS) dst[i] = src[i];
  }
  unsigned bq[NT][KS][2];
  load_queries(q8, qbase, wq, lane, bq);

  // Rebuild local slab s into buffer s & 1: thread tid writes 16-byte
  // pieces 4h .. 4h+3 of row r and the pair sums the row's norm.
  auto rebuild = [&](int s) {
    const int r = tid >> 1, h = tid & 1;
    const uint8_t* rc = cds + (s & 1) * SLAB * M + r * M;
    int4* dst = reinterpret_cast<int4*>(slab + ((s & 1) * SLAB + r) * PITCH);
    // subspace j's entry: its first byte
    auto entry = [&](int j) { return cb + (j * ksub + rc[j]) * DSUB; };
    int nrm = 0;
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      const int c = 4 * h + k4;
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
      } else {  // DSUB 2 or 1 (m 64, 128): an entry is part of a word
        constexpr int PER = 4 / DSUB, J = 4 * PER;  // entries a word, a piece
        unsigned cw[J / 4];  // the piece's codes, four to a word, in one load
        if constexpr (J == 16) {
          const uint4 t = *reinterpret_cast<const uint4*>(rc + J * c);
          cw[0] = t.x, cw[1] = t.y, cw[2] = t.z, cw[3] = t.w;
        } else {
          const uint2 t = *reinterpret_cast<const uint2*>(rc + J * c);
          cw[0] = t.x, cw[1] = t.y;
        }
        int e[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          unsigned x = 0;
#pragma unroll
          for (int u = 0; u < PER; ++u) {
            const int jj = k * PER + u;  // the subspace's place in the piece
            const int code = (cw[jj / 4] >> (8 * (jj % 4))) & 255;
            const unsigned char* p = cb + ((J * c + jj) * ksub + code) * DSUB;
            const unsigned piece =
                DSUB == 2 ? *reinterpret_cast<const unsigned short*>(p) : *p;
            x |= piece << (8 * DSUB * u);
          }
          e[k] = static_cast<int>(x);
        }
        v = make_int4(e[0], e[1], e[2], e[3]);
      }
      nrm = dot16(v, v, nrm);
      dst[c] = v;
    }
    nrm += __shfl_xor_sync(0xffffffffu, nrm, 1);
    const int row = row_first + s * SLAB + r;
    if (h == 0) rn[(s & 1) * SLAB + r] = row < max(ntotal, 0) ? (float)nrm : BIG;
  };

  cp_async_wait<1>();
  __syncthreads();  // the codebook and slab 0's codes are in shared memory
  rebuild(0);

  Best best;
  best.reset();
  const unsigned slab_s = smem_addr(slab);
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<0>();
    // slab s and its norms are staged, slab s+1's codes have arrived, and
    // every read of buffer (s+1) & 1, of codes slot s & 1 and of the
    // window sums of window s / spw - 2 is done
    __syncthreads();
    if (s > 0 && s % spw == 0) combine(redv, redr, s / spw - 1, win0, qbase, qp, vals, args);
    issue_codes(s + 2);
    if (s + 1 < nslab) rebuild(s + 1);
    slab_scan(slab_s + (s & 1) * SLAB * PITCH, rn + (s & 1) * SLAB, bq, ratio2,
              row_first + s * SLAB, wr, lane, best);
    if ((s + 1) % spw == 0)  // window s / spw ends
      window_fold(best, redv, redr, (s / spw) & 1, wr, wq, lane);
  }
  __syncthreads();
  if (nslab > 0) combine(redv, redr, nslab / spw - 1, win0, qbase, qp, vals, args);
}

template <int M>
int launch(const void* q8, const void* codes, const void* cent8, void* vals, void* args,
           int qp, int np, int w, int ntotal, float ratio2, int ksub,
           cudaStream_t stream) {
  const size_t smem = SLAB_BYTES + RED_BYTES + RN_BYTES + (size_t)ksub * D +
                      (size_t)2 * SLAB * M;
  cudaError_t err = cudaFuncSetAttribute(
      pq_winmin_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nwin = np / w;
  const dim3 grid(qp / QB, (nwin + WPB - 1) / WPB);
  pq_winmin_kernel<M><<<grid, THREADS, smem, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const uint8_t*>(codes),
      static_cast<const int8_t*>(cent8), static_cast<float*>(vals),
      static_cast<int*>(args), qp, nwin, w, ntotal, ratio2, ksub);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q8 [qp, 128] int8, codes [np, m] uint8 (each < ksub), cent8 [m, ksub,
// 128/m] int8, codes and cent8 16-byte aligned -> vals, args [np / w, qp]
// (f32, i32).
// qp % 128 == 0, w % 128 == 0, np % w == 0, m dividing 128, ksub <= 256.
extern "C" int pq_winmin(const void* q8, const void* codes, const void* cent8,
                         void* vals, void* args, int qp, int np, int w,
                         int ntotal, float ratio2, int m, int ksub,
                         void* stream) {
  static_assert(SLAB_BYTES + RED_BYTES + RN_BYTES + CB_BYTES_MAX + 2 * SLAB * M_MAX <=
                    227 * 1024, "shared memory");
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PQ_CASE(M)                                                                   \
  case M:                                                                            \
    return launch<M>(q8, codes, cent8, vals, args, qp, np, w, ntotal, ratio2, ksub, st);
  switch (m) {
    PQ_CASE(1) PQ_CASE(2) PQ_CASE(4) PQ_CASE(8) PQ_CASE(16) PQ_CASE(32) PQ_CASE(64)
    PQ_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PQ_CASE
}

extern "C" const char* pq_winmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
