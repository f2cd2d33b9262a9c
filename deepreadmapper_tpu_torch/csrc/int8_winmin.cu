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
// What bounds it on an H100: int8 operations.  2^18 rows x 8192 queries x
// 128 x 2 is 5.5e11, 0.278 ms at the tensor cores' 1,979 TOP/s (dense).
// The output is W = 128 times smaller than the score matrix, and each row
// (128 B) is read from device memory once; the 64 query blocks that share
// a row range read it again from L2 (blockIdx.x is the query tile, so they
// run together).
//
// Design: the TPU kernel computes a [4096 rows x 512 queries] score tile in
// VMEM per grid step and reduces windows there.  Here a block of 8 warps
// owns 128 queries and 32 consecutive windows and runs the scan block of
// winmin.cuh (int8 mma.sync m16n8k32, the queries' B fragments in
// registers, a per-thread (min, row) fold and lexicographic window
// combines), shared with pq_winmin.cu.  The rows arrive by cp.async, two
// 128-row slabs ahead, into a ring of three slabs at a 144-byte pitch;
// two threads sum each staged row's exact norm with __dp4a and mask it;
// the norms of slab s+1 and the products of slab s sit between the same
// two barriers, one barrier a slab.
#include "winmin.cuh"

namespace {

using namespace winmin;
using namespace winmin::scan;

constexpr int NBUF = 3;  // slabs staged: s (products), s+1 (norms), s+2 (arriving)
static_assert(THREADS == 2 * SLAB, "two threads sum each slab row's norm");
static_assert(SLAB * D / 16 % THREADS == 0, "whole 16-byte copies a thread");

constexpr size_t SLAB_BYTES = NBUF * SLAB * PITCH;
constexpr size_t RN_BYTES = 2 * SLAB * 4;
constexpr size_t SMEM = SLAB_BYTES + RN_BYTES + RED_BYTES;

__global__ void __launch_bounds__(THREADS, 2)
int8_winmin_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ r8,
                   float* __restrict__ vals, int* __restrict__ args, int qp,
                   int nwin, int w, int ntotal, float ratio2) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* slab = smem;                                 // [NBUF][SLAB][PITCH]
  float* rn = reinterpret_cast<float*>(smem + SLAB_BYTES);    // [2][SLAB]
  float* redv = rn + 2 * SLAB;                                // [2][2][QB]
  int* redr = reinterpret_cast<int*>(redv + 2 * 2 * QB);      // [2][2][QB]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 2, wq = warp & 3;
  const int spw = w / SLAB;  // slabs a window
  const int win0 = blockIdx.y * WPB;
  const int nslab = (min(win0 + WPB, nwin) - win0) * spw;
  const int row_first = win0 * w;
  const int qbase = blockIdx.x * QB;
  const unsigned slab_s = smem_addr(slab);

  auto issue = [&](int s) {  // rows of local slab s into buffer s % NBUF
    if (s < nslab) {
      const int8_t* src = r8 + ((size_t)row_first + (size_t)s * SLAB) * D;
      const unsigned dst = slab_s + (s % NBUF) * SLAB * PITCH;
#pragma unroll
      for (int k = 0; k < SLAB * D / 16 / THREADS; ++k) {
        const int j = tid + k * THREADS, r = j >> 3, c = j & 7;
        cp_async16(dst + r * PITCH + 16 * c, src + r * D + 16 * c);
      }
    }
    cp_async_commit();
  };
  // The masked norm of slab s's rows into rn[s & 1]: thread pair r sums
  // bytes 64h .. 64h + 63 of row r.
  auto norm = [&](int s) {
    const int r = tid >> 1, h = tid & 1;
    const int4* src = reinterpret_cast<const int4*>(slab + ((s % NBUF) * SLAB + r) * PITCH) + 4 * h;
    int nrm = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int4 v = src[c];
      nrm = dot16(v, v, nrm);
    }
    nrm += __shfl_xor_sync(0xffffffffu, nrm, 1);
    const int row = row_first + s * SLAB + r;
    if (h == 0) rn[(s & 1) * SLAB + r] = row < max(ntotal, 0) ? (float)nrm : BIG;
  };

  issue(0);
  issue(1);
  unsigned bq[NT][KS][2];
  load_queries(q8, qbase, wq, lane, bq);
  cp_async_wait<1>();
  __syncthreads();  // slab 0 is in shared memory
  norm(0);

  Best best;
  best.reset();
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<0>();
    // slab s and its norms are staged, slab s+1 has arrived, and every
    // read of buffer (s+2) % NBUF, of rn[(s+1) & 1] and of the window sums
    // of window s / spw - 2 is done
    __syncthreads();
    if (s > 0 && s % spw == 0) combine(redv, redr, s / spw - 1, win0, qbase, qp, vals, args);
    issue(s + 2);
    if (s + 1 < nslab) norm(s + 1);
    slab_scan(slab_s + (s % NBUF) * SLAB * PITCH, rn + (s & 1) * SLAB, bq, ratio2,
              row_first + s * SLAB, wr, lane, best);
    if ((s + 1) % spw == 0)  // window s / spw ends
      window_fold(best, redv, redr, (s / spw) & 1, wr, wq, lane);
  }
  __syncthreads();
  if (nslab > 0) combine(redv, redr, nslab / spw - 1, win0, qbase, qp, vals, args);
}

}  // namespace

// q8 [qp, 128] int8 row-major, r8 [np, 128] int8, 16-byte aligned -> vals,
// args [np / w, qp] (f32, i32).  qp % 128 == 0, w % 128 == 0, np % w == 0.
extern "C" int int8_winmin(const void* q8, const void* r8, void* vals,
                           void* args, int qp, int np, int w, int ntotal,
                           float ratio2, void* stream) {
  static_assert(SMEM <= 227 * 1024, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      int8_winmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nwin = np / w;
  const dim3 grid(qp / QB, (nwin + WPB - 1) / WPB);
  int8_winmin_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(r8),
      static_cast<float*>(vals), static_cast<int*>(args), qp, nwin, w, ntotal,
      ratio2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_winmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
