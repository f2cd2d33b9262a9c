// Smith-Waterman local score of each (a, b) byte pair: +1 match, -1
// mismatch, linear gap -1, the score is the max DP cell.
//
// Replaces deepreadmapper_tpu/ops/sw_pallas.py::_sw_kernel (driven by
// _sw_pallas_call, sw_scores_pallas / sw_scores_auto), the SW rerank of
// `pipeline --rerank sw`: a = candidate genome windows, b = '<'-wrapped reads.
//
// What bounds it on an H100: instruction issue.  The DP has no tensor-core
// form and reads only the pairs' bytes.  Every value fits in 16 bits (a
// score is at most min(la, lb), which ops/sw.py keeps below 2^15, and the
// relu floor keeps cells >= 0),
// so Hopper's DPX instructions carry two pairs in each register, one in
// each 16-bit half, and a pair of cells costs 5.5 instructions:
//   z    = A ^ B[k]                  A = ~2a, B = 2b: -1 on a match, <= -3 else
//   s1   = viaddmax_relu(z, 3, z)    2 on a match, 0 else (s + 1)
//   x    = viaddmax(D, s1, U[k])     max(Hd + s, Hu - 1); the row above is kept as H - 1
//   H    = viaddmax_relu(H, -1, x)   max(Hl - 1, x, 0), the only link along the row
//   U[k] = viaddmax(H, -1, z)        H - 1 for the row below (z <= -1 <= H - 1)
//   best = vimax3(best, x, x')       one for two cells (the max H is max(x, 0))
// Each takes at most one constant, as an immediate: a second one (0 or -1)
// would cost a register move nearly every time (ptxas rematerialises it).
// chip_smoke.py counts these (SW_OPS_PER_CELL) against the DPX rate it
// measures with sw_dpx_rate below.
//
// Design, against the three things that held the first version back:
// - One pair a thread filled 40 of 132 SMs at the main path's 5,120-pair
//   launches.  Here a group of G lanes of one warp (G a power of two up to
//   32, chosen by ops/sw.py::sw_layout from P and lc) shares two pairs, so a
//   launch has P/2 x G lanes.  Lane g holds S columns of b and the row
//   above them in registers and walks the rows one step behind lane g - 1:
//   row i at step i + g.  After each row it hands its last column's H to
//   lane g + 1 by __shfl_up_sync; that is lane g + 1's left for row i and,
//   less one, its diagonal for row i + 1.  The group's best is reduced by
//   __shfl_xor_sync at the end.  When lc needs more than S columns a lane
//   even at G = 32, the strip is walked in passes, lane G - 1's right edge
//   kept in shared memory for lane 0 of the next pass.
// - Seven or eight scalar int32 instructions a cell are 2.75 here (above).
// - A block's 58 KB of shared memory (the a rows and an int16 edge column a
//   thread) allowed 3 blocks an SM.  Now shared memory holds only the packed
//   A word of each group and row (NG x lr x 4 bytes; 19 KB at G = 4, lr 150),
//   read by all lanes of a group at once (a broadcast).
// Bytes past a pair's la read as 254 and past lb as 255 (the sentinels of
// ops/sw.py): they never match, so cells there only decay and the best
// stays the true-length DP's.  Each group runs to the longer of its two la;
// a missing second pair (odd P) has length 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned M1 = 0xffffffffu;     // (-1, -1)
constexpr unsigned THREE = 0x00030003u;  // (3, 3)
constexpr unsigned PAD_A = 254u;
constexpr unsigned PAD_B = 255u;

__device__ __forceinline__ int clamp_len(int n, int width) {
  return min(max(n, 0), width);
}

template <int S>
__global__ void __launch_bounds__(THREADS)
sw_score_kernel(const uint8_t* __restrict__ a, const int* __restrict__ alen,
                const uint8_t* __restrict__ b, const int* __restrict__ blen,
                int* __restrict__ out, int np, int lr, int lc, int G, int passes) {
  extern __shared__ unsigned smem[];
  const int ng = THREADS / G;          // groups of the block, two pairs each
  const int pitch = lr | 1;            // odd: the groups' words of a row fall in distinct banks
  unsigned* a_sh = smem;               // [ng][pitch] A words
  unsigned* edge = smem + ng * pitch;  // [2][ng][lr] right edges between passes

  const int tid = threadIdx.x;
  const int grp = tid / G, g = tid % G;
  const int p0 = blockIdx.x * 2 * ng;  // the block's pairs are contiguous
  const int rows_here = min(2 * ng, np - p0);

  // A word of a row: ~2a of pair 2m in the low half, of pair 2m + 1 in the high
  uint16_t* a16 = reinterpret_cast<uint16_t*>(a_sh);
  const uint8_t* ablk = a + (size_t)p0 * lr;
  for (int idx = tid; idx < 2 * ng * lr; idx += THREADS) {
    const int t = idx / lr, i = idx - t * lr;
    unsigned byte = PAD_A;
    if (t < rows_here && i < clamp_len(alen[p0 + t], lr)) byte = ablk[idx];
    a16[((t >> 1) * pitch + i) * 2 + (t & 1)] = (uint16_t)~(byte << 1);
  }
  __syncthreads();

  const int plo = p0 + 2 * grp, phi = plo + 1;
  const int la = max(plo < np ? clamp_len(alen[plo], lr) : 0,
                     phi < np ? clamp_len(alen[phi], lr) : 0);
  const int lb_lo = plo < np ? clamp_len(blen[plo], lc) : 0;
  const int lb_hi = phi < np ? clamp_len(blen[phi], lc) : 0;
  const uint8_t* b_lo = b + (size_t)min(plo, np - 1) * lc;
  const uint8_t* b_hi = b + (size_t)min(phi, np - 1) * lc;
  const int steps = (int)__reduce_max_sync(FULL, (unsigned)la) + G - 1;
  const unsigned* arow = a_sh + grp * pitch - g;  // arow[t]: the row lane g takes at step t

  unsigned best = 0;
  for (int q = 0; q < passes; ++q) {
    const int c0 = (q * G + g) * S;
    unsigned bw[S], up[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int c = c0 + k;
      const unsigned lo = c < lb_lo ? b_lo[c] : PAD_B;
      const unsigned hi = c < lb_hi ? b_hi[c] : PAD_B;
      bw[k] = (lo << 1) | (hi << 17);
      up[k] = M1;  // the row above row 0: H = 0
    }
    const unsigned* ein = edge + (size_t)(((q + 1) & 1) * ng + grp) * lr;  // pass q - 1's
    unsigned* eout = edge + (size_t)((q & 1) * ng + grp) * lr;
    unsigned right = 0, dm1 = M1;  // dm1: H[i-1][c0-1] - 1
    for (int t = 0; t < steps; ++t) {
      unsigned h = __shfl_up_sync(FULL, right, 1, G);  // lane g - 1's H[i][c0-1]
      const int i = t - g;
      const bool active = (unsigned)i < (unsigned)la;
      if (g == 0) h = (q > 0 && active) ? ein[i] : 0u;
      if (active) {
        const unsigned A = arow[t];
        const unsigned left = h;
        unsigned diag = dm1, x_even = 0;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const unsigned z = A ^ bw[k];
          const unsigned s1 = __viaddmax_s16x2_relu(z, THREE, z);
          const unsigned x = __viaddmax_s16x2(diag, s1, up[k]);
          if (k & 1) best = __vimax3_s16x2_relu(best, x_even, x);
          else x_even = x;
          diag = up[k];
          h = __viaddmax_s16x2_relu(h, M1, x);
          up[k] = __viaddmax_s16x2(h, M1, z);
        }
        if (S & 1) best = __vimax_s16x2_relu(best, x_even);
        right = h;
        if (g == G - 1 && q + 1 < passes) eout[i] = h;
        dm1 = __viaddmax_s16x2(left, M1, A);  // left - 1 (A <= -1)
      }
    }
    __syncwarp();  // eout complete before the next pass reads it
  }
  for (int o = G >> 1; o > 0; o >>= 1)
    best = __vimax_s16x2_relu(best, __shfl_xor_sync(FULL, best, o, G));
  if (g == 0) {
    if (plo < np) out[plo] = (int)(best & 0xffffu);
    if (phi < np) out[phi] = (int)(best >> 16);
  }
}

template <int S>
int launch(const void* a, const void* alen, const void* b, const void* blen,
           void* out, int np, int lr, int lc, int G, int passes,
           cudaStream_t stream) {
  const int ng = THREADS / G;
  const size_t smem = ((size_t)ng * (lr | 1) + (passes > 1 ? (size_t)2 * ng * lr : 0)) *
                      sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sw_score_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = ((np + 1) / 2 + ng - 1) / ng;
  sw_score_kernel<S><<<blocks, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const int*>(alen),
      static_cast<const uint8_t*>(b), static_cast<const int*>(blen),
      static_cast<int*>(out), np, lr, lc, G, passes);
  return static_cast<int>(cudaGetLastError());
}

// A loop of independent DPX add-max instructions on every scheduler: the
// rate the bound of sw_score divides by (chip_smoke.py).
__global__ void __launch_bounds__(256) dpx_rate_kernel(unsigned* out, int iters) {
  unsigned v[8];
  const unsigned c = (unsigned)iters * 0x00050003u;
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = (threadIdx.x + 37u * j) * 0x00010001u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __viaddmax_s16x2_relu(v[j], M1, c);
    }
  }
  unsigned r = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) r ^= v[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

}  // namespace

// a [np, lr] uint8, alen [np] int32, b [np, lc] uint8, blen [np] int32 ->
// out [np] int32.  groups G (a power of two <= 32), strip S (columns a lane
// holds, one of the instantiations below) and passes come from
// ops/sw.py::sw_layout; G x S x passes >= lc.
extern "C" int sw_score(const void* a, const void* alen, const void* b,
                        const void* blen, void* out, int np, int lr, int lc,
                        int groups, int strip, int passes, void* stream) {
  if (groups < 1 || groups > 32 || (groups & (groups - 1)) || passes < 1 ||
      (long long)groups * strip * passes < lc)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SW_CASE(S)                                                            \
  case S:                                                                     \
    return launch<S>(a, alen, b, blen, out, np, lr, lc, groups, passes, st);
  switch (strip) {
    SW_CASE(1) SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5) SW_CASE(6)
    SW_CASE(8) SW_CASE(10) SW_CASE(12) SW_CASE(16) SW_CASE(20) SW_CASE(24)
    SW_CASE(32) SW_CASE(40)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SW_CASE
}

// out [blocks x 256] uint32; each thread runs iters x 32
// __viaddmax_s16x2_relu instructions.
extern "C" int sw_dpx_rate(void* out, int blocks, int iters, void* stream) {
  dpx_rate_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
