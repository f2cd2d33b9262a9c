// Fused int8 scan: score every (row, query) pair and keep only the
// (min, lowest argmin) of each window of W rows.
//
// Replaces deepreadmapper_tpu/ops/scan_kernel.py::_int8_kernel (driven by
// _int8_winmin_call / fused_scan_topk), the INT8FLAT engine's scan at
// N >= 2^18 rows.
//
// Score: s = rn - ratio2 * (q . r), rn = ||r||^2, with rows at or past
// ntotal given rn = 3.4e38 so they never win.  Dot products are exact int32;
// every term is below 2^24, so the fp32 score is exact at ratio2 = 2.  At
// ratio2 != 2 one rounding step decides the last bit: the score is rounded
// ONCE, as an explicit __fmaf_rn(-ratio2, dot, rn).  That is what the JAX
// package computes (XLA fuses the expression into one FMA; measured on its
// CPU backend) and what the plain version computes in float64 (exact there)
// before its single rounding to fp32.  Writing the FMA out keeps the result
// independent of whether nvcc would contract a separate multiply/subtract.
//
// What bounds it on an H100: int8 dot throughput.  The output is W = 128
// times smaller than the score matrix, so device memory traffic is small;
// this first version runs the dots as __dp4a on the CUDA cores (tensor-core
// int8 is left to a later version).
//
// Design: the TPU kernel computes a [4096 rows x 512 queries] score tile in
// VMEM per grid step and reduces windows there.  Here a block owns QTILE
// queries (one per thread, its 128 bytes held in 32 registers) and walks
// WPB consecutive windows.  Each 128-row slab of a window is staged in
// shared memory (16 KB) with its masked norms; every thread then reads the
// slab as broadcasts, so each row is fetched from device memory once per
// block and scored against 128 queries (winmin.cuh, shared with
// pq_winmin.cu).
#include "winmin.cuh"

namespace {

using namespace winmin;

__global__ void __launch_bounds__(QTILE)
int8_winmin_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ r8,
                   float* __restrict__ vals, int* __restrict__ args, int qp,
                   int nwin, int w, int ntotal, float ratio2) {
  __shared__ int4 rows[SLAB * PITCH];
  __shared__ float rn[SLAB];

  const int tid = threadIdx.x;
  const int q = blockIdx.x * QTILE + tid;
  int4 qv[V];
  load_query(q8, q, qv);

  const int win0 = blockIdx.y * WPB;
  const int win1 = min(win0 + WPB, nwin);
  for (int win = win0; win < win1; ++win) {
    float best = INFINITY;
    int best_row = 0;
    for (int row0 = win * w; row0 < (win + 1) * w; row0 += SLAB) {
      __syncthreads();  // the previous slab is no longer read
      const int4* src = reinterpret_cast<const int4*>(r8 + (size_t)row0 * D);
      for (int i = tid; i < SLAB * V; i += QTILE)
        rows[(i / V) * PITCH + i % V] = src[i];
      __syncthreads();
      rn[tid] = slab_norm(rows, tid, row0, ntotal);
      __syncthreads();
      slab_scan(rows, rn, qv, ratio2, row0, best, best_row);
    }
    vals[(size_t)win * qp + q] = best;
    args[(size_t)win * qp + q] = best_row;
  }
}

}  // namespace

// q8 [qp, 128] int8 row-major, r8 [np, 128] int8 -> vals, args [np / w, qp]
// (f32, i32).  qp % 128 == 0, w % 128 == 0, np % w == 0.
extern "C" int int8_winmin(const void* q8, const void* r8, void* vals,
                           void* args, int qp, int np, int w, int ntotal,
                           float ratio2, void* stream) {
  const int nwin = np / w;
  const dim3 grid(qp / QTILE, (nwin + WPB - 1) / WPB);
  int8_winmin_kernel<<<grid, QTILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(r8),
      static_cast<float*>(vals), static_cast<int*>(args), qp, nwin, w, ntotal,
      ratio2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_winmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
