// Smith-Waterman local score of each (a, b) byte pair: +1 match, -1
// mismatch, linear gap -1, the score is the max DP cell.
//
// Replaces deepreadmapper_tpu/ops/sw_pallas.py::_sw_kernel (driven by
// sw_scores_pallas / sw_scores_auto), the SW rerank of `pipeline --rerank sw`:
// a = candidate genome windows, b = '<'-wrapped reads.
//
// What bounds it on an H100: integer instruction throughput.  Every cell
// is a short chain of max/add operations (the DP has no tensor-core form),
// and each cell depends on its left neighbour, so the work is la * lb
// dependent-ish integer steps per pair.  Memory traffic is tiny (the
// pair's bytes once).
//
// Design: the TPU kernel runs an anti-diagonal wavefront with pairs on the
// 128 vector lanes, because Mosaic rejects int16 and wide lane blocks.  Here
// each thread owns one pair and runs the plain row-by-row DP over the true
// lengths.  The b axis is cut into strips of S = 16 columns; a strip's DP
// row lives in 16 registers and its b bytes in 4 registers, and the strip
// walks all rows of a.  The column at the strip's right edge is handed to
// the next strip through shared memory (int16, one column of la cells per
// thread), so each cell costs registers only and each row of a strip
// costs one shared load and one shared store.  The block's a rows are
// staged transposed in shared memory with a padded pitch (conflict-free).
// Columns past lb in the last strip hold the sentinel 255, which never
// matches, so they stay below the running max (the sentinel argument of
// ops/sw.py); rows stop at la exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;        // pairs per block, one per thread
constexpr int S = 16;               // columns of b per register strip
constexpr int APITCH = THREADS + 4; // byte pitch of the staged a rows
constexpr unsigned PAD_B = 255u;

__global__ void __launch_bounds__(THREADS)
sw_score_kernel(const uint8_t* __restrict__ a, const int* __restrict__ alen,
                const uint8_t* __restrict__ b, const int* __restrict__ blen,
                int* __restrict__ out, int np, int lr, int lc) {
  extern __shared__ uint8_t smem[];
  uint8_t* a_sh = smem;                                        // [lr][APITCH]
  int16_t* edge = reinterpret_cast<int16_t*>(smem + ((lr * APITCH + 15) & ~15));  // [lr][THREADS]

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * THREADS;
  // The block's a rows are contiguous: stage them transposed, coalesced.
  const int rows_here = min(THREADS, np - p0);
  const uint8_t* ablk = a + (size_t)p0 * lr;
  for (int idx = tid; idx < rows_here * lr; idx += THREADS) {
    const int t = idx / lr;
    a_sh[(idx - t * lr) * APITCH + t] = ablk[idx];
  }
  __syncthreads();
  const int p = p0 + tid;
  if (p >= np) return;

  const int la = min(max(alen[p], 0), lr);
  const int lb = min(max(blen[p], 0), lc);
  const uint8_t* brow = b + (size_t)p * lc;
  for (int i = 0; i < la; ++i) edge[i * THREADS + tid] = 0;  // H[i][0] = 0

  int best = 0;
  for (int j0 = 0; j0 < lb; j0 += S) {
    unsigned bw[S / 4];
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      unsigned word = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + 4 * q + c;
        word |= (j < lb ? (unsigned)brow[j] : PAD_B) << (8 * c);
      }
      bw[q] = word;
    }
    int h[S];
#pragma unroll
    for (int j = 0; j < S; ++j) h[j] = 0;  // row 0
    int prev_edge = 0;                       // H[0][j0-1]
    for (int i = 0; i < la; ++i) {
      const unsigned a4 = a_sh[i * APITCH + tid] * 0x01010101u;
      const int left0 = edge[i * THREADS + tid];  // H[i][j0-1]
      int diag = prev_edge;                       // H[i-1][j0-1]
      int left = left0;
#pragma unroll
      for (int q = 0; q < S / 4; ++q) {
        const unsigned eq = __vcmpeq4(a4, bw[q]);  // 0xff per equal byte
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * q + c;
          const int s = (int)((eq >> (8 * c)) & 2u) - 1;  // +1 or -1
          const int up = h[j];
          const int v = max(max(diag + s, 0), max(up, left) - 1);
          diag = up;
          h[j] = v;
          left = v;
          best = max(best, v);
        }
      }
      edge[i * THREADS + tid] = (int16_t)left;  // H[i][j0+S-1]
      prev_edge = left0;
    }
  }
  out[p] = best;
}

}  // namespace

// a [np, lr] uint8, alen [np] int32, b [np, lc] uint8, blen [np] int32 ->
// out [np] int32.  lr <= 512 (shared memory).
extern "C" int sw_score(const void* a, const void* alen, const void* b,
                        const void* blen, void* out, int np, int lr, int lc,
                        void* stream) {
  const size_t smem = ((size_t)(lr * APITCH + 15) & ~(size_t)15) +
                      (size_t)lr * THREADS * sizeof(int16_t);
  cudaError_t err = cudaFuncSetAttribute(
      sw_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (np + THREADS - 1) / THREADS;
  sw_score_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const int*>(alen),
      static_cast<const uint8_t*>(b), static_cast<const int*>(blen),
      static_cast<int*>(out), np, lr, lc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
