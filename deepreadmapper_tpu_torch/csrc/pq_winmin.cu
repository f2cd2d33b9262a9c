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
// masked to 3.4e38, rounded once as an FMA (see int8_winmin.cu); the
// scoring loop is shared through winmin.cuh.
//
// What bounds it on an H100: int8 dot throughput, as for int8_winmin.cu.
// The codes are 8 B per row instead of 128 B, so device memory traffic is
// 16x smaller still; the rebuild costs 32 shared-memory word copies per
// row and block, against 128 rows x 32 dp4a per thread for the scores.
//
// Design: the TPU kernel rebuilds a [128, 4096] tile per grid step with
// one-hot x block-diagonal-codebook matmuls on the MXU (codes stored
// transposed for its (8, 128) lane tiling).  Here the block stages the whole
// int8 codebook in shared memory once (ksub x 128 B, at most 32 KB); for each
// 128-row slab, thread t reads the m codes of row t ([Np, m] layout) and
// copies the m codebook entries into the shared slab, computes that row's
// norm from the rebuilt bytes, and then all threads score the slab as in
// the int8 scan.
#include "winmin.cuh"

namespace {

using namespace winmin;

constexpr int CB_BYTES_MAX = 256 * D;  // ksub <= 256 entries of 128 B

__global__ void __launch_bounds__(QTILE)
pq_winmin_kernel(const int8_t* __restrict__ q8, const uint8_t* __restrict__ codes,
                 const int8_t* __restrict__ cent8, float* __restrict__ vals,
                 int* __restrict__ args, int qp, int nwin, int w, int ntotal,
                 float ratio2, int m, int ksub) {
  extern __shared__ int4 smem[];
  int4* rows = smem;                                          // [SLAB][PITCH]
  float* rn = reinterpret_cast<float*>(rows + SLAB * PITCH);  // [SLAB]
  int* cb = reinterpret_cast<int*>(rn + SLAB);                // [m][ksub][dsub/4]

  const int tid = threadIdx.x;
  const int cb_words = ksub * (D / 4);
  const int* cent_w = reinterpret_cast<const int*>(cent8);
  for (int i = tid; i < cb_words; i += QTILE) cb[i] = cent_w[i];

  const int q = blockIdx.x * QTILE + tid;
  int4 qv[V];
  load_query(q8, q, qv);

  const int dsw = (D / 4) / m;  // codebook words per subspace entry
  const int win0 = blockIdx.y * WPB;
  const int win1 = min(win0 + WPB, nwin);
  for (int win = win0; win < win1; ++win) {
    float best = INFINITY;
    int best_row = 0;
    for (int row0 = win * w; row0 < (win + 1) * w; row0 += SLAB) {
      __syncthreads();  // the codebook is staged / the previous slab is no longer read
      int* dst = reinterpret_cast<int*>(rows + tid * PITCH);
      const uint8_t* crow = codes + (size_t)(row0 + tid) * m;
      for (int j = 0; j < m; ++j) {
        const int* src = cb + (j * ksub + crow[j]) * dsw;
        for (int u = 0; u < dsw; ++u) dst[j * dsw + u] = src[u];
      }
      rn[tid] = slab_norm(rows, tid, row0, ntotal);  // this thread's own row
      __syncthreads();
      slab_scan(rows, rn, qv, ratio2, row0, best, best_row);
    }
    vals[(size_t)win * qp + q] = best;
    args[(size_t)win * qp + q] = best_row;
  }
}

}  // namespace

// q8 [qp, 128] int8, codes [np, m] uint8 (each < ksub), cent8 [m, ksub,
// 128/m] int8 -> vals, args [np / w, qp] (f32, i32).  qp % 128 == 0,
// w % 128 == 0, np % w == 0, 128 / m a multiple of 4, ksub <= 256.
extern "C" int pq_winmin(const void* q8, const void* codes, const void* cent8,
                         void* vals, void* args, int qp, int np, int w,
                         int ntotal, float ratio2, int m, int ksub,
                         void* stream) {
  const size_t smem = sizeof(int4) * SLAB * PITCH + sizeof(float) * SLAB +
                      (size_t)ksub * D;
  static_assert(sizeof(int4) * SLAB * PITCH + sizeof(float) * SLAB +
                    CB_BYTES_MAX <= 227 * 1024, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      pq_winmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nwin = np / w;
  const dim3 grid(qp / QTILE, (nwin + WPB - 1) / WPB);
  pq_winmin_kernel<<<grid, QTILE, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const uint8_t*>(codes),
      static_cast<const int8_t*>(cent8), static_cast<float*>(vals),
      static_cast<int*>(args), qp, nwin, w, ntotal, ratio2, m, ksub);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pq_winmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
