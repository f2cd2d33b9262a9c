// Fused input projection + GRU recurrence, forward only.
//
// Replaces deepreadmapper_tpu/models/gru_pallas.py::_gru_proj_kernel, the
// Pallas TPU kernel behind gru_proj_seq / gru_proj_last (4 calls per encoder
// batch: layer 1 fwd/bwd over all steps, layer 2 fwd/bwd at the last step).
//
// Math per step (gate order z, r, n; linear_before_reset):
//   gx = x_t W + bzr,  gh = h R
//   z = sigmoid(gx_z + gh_z), r = sigmoid(gx_r + gh_r)
//   n = tanh(gx_n + r * (gh_n + rbh)),  h = (1 - z) n + z h
//
// What bounds it on an H100: fp32 FMA on the CUDA cores.  Each sequence and
// step costs (din + 64) x 192 multiply-adds for din + 64 loaded values, about
// 96 FLOP per byte of fp32 x in layer 1, so device memory is far from the
// limit; shared-memory loads feeding the FMAs are the next one.
//
// Design: the TPU kernel walks time in the grid's inner dimension and carries
// h in VMEM scratch from one grid step to the next.  Blocks on Hopper run in
// no order and carry nothing, so here each block owns BS sequences and loops
// over all T steps itself (forward or reverse by index; outputs land in their
// original time positions).  W and R sit in shared memory as fp32 for the
// whole kernel (din = 128 needs ~156 KB, granted through
// cudaFuncSetAttribute).  Thread (j, g) owns hidden unit j of S sequences:
// it keeps their h in registers, accumulates the three gate columns
// j, 64 + j, 128 + j for them, and publishes h to shared memory for the next
// step's h R.  x_t is staged in shared memory once per step and read as
// float4 broadcasts.  The ragged batch edge is masked: rows past the batch
// read zeros and are never stored.  Inputs are fp32 or bf16; gate math and
// the carry are fp32, per-step outputs are in the input dtype, h_last fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 64;
constexpr int G = 3 * H;
constexpr int GROUPS = 4;               // thread groups of H threads
constexpr int S = 4;                    // sequences per thread
constexpr int BS = GROUPS * S;          // sequences per block
constexpr int THREADS = GROUPS * H;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// One k-slice of 4 inputs: acc += in[s][k..k+3] * wgt[k..k+3][col]
#define GRU_ACC4(in_vec, wgt, col, acc)                                   \
  {                                                                       \
    const float w0 = wgt[(k + 0) * G + (col)];                            \
    const float w1 = wgt[(k + 1) * G + (col)];                            \
    const float w2 = wgt[(k + 2) * G + (col)];                            \
    const float w3 = wgt[(k + 3) * G + (col)];                            \
    _Pragma("unroll") for (int s = 0; s < S; ++s) {                       \
      acc[s] = fmaf(in_vec[s].x, w0, acc[s]);                             \
      acc[s] = fmaf(in_vec[s].y, w1, acc[s]);                             \
      acc[s] = fmaf(in_vec[s].z, w2, acc[s]);                             \
      acc[s] = fmaf(in_vec[s].w, w3, acc[s]);                             \
    }                                                                     \
  }

template <typename T>
__global__ void __launch_bounds__(THREADS)
gru_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bzr, const float* __restrict__ r,
               const float* __restrict__ rbh, T* __restrict__ hs,
               float* __restrict__ h_last, int t_steps, int batch, int din,
               int reverse) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;              // [din][G]
  float* rs = ws + din * G;      // [H][G]
  float* xs = rs + H * G;        // [BS][din]
  float* hsm = xs + BS * din;    // [BS][H]

  const int tid = threadIdx.x;
  const int j = tid % H;
  const int g = tid / H;
  const int b0 = blockIdx.x * BS;

  for (int i = tid; i < din * G; i += THREADS) ws[i] = w[i];
  for (int i = tid; i < H * G; i += THREADS) rs[i] = r[i];
  for (int i = tid; i < BS * H; i += THREADS) hsm[i] = 0.0f;
  const float bz = bzr[j], br = bzr[H + j], bn = bzr[2 * H + j];
  const float bh = rbh[j];

  float h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) h[s] = 0.0f;

  for (int step = 0; step < t_steps; ++step) {
    const int t = reverse ? t_steps - 1 - step : step;
    const T* xt = x + ((size_t)t * batch + b0) * din;
    const int rows = min(BS, batch - b0);
    for (int i = tid; i < BS * din; i += THREADS)
      xs[i] = (i / din < rows) ? to_float(xt[i]) : 0.0f;
    __syncthreads();  // xs of this step and hsm of the last one are ready

    float az[S], ar[S], axn[S], ahn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      az[s] = bz;
      ar[s] = br;
      axn[s] = bn;
      ahn[s] = 0.0f;
    }
    for (int k = 0; k < din; k += 4) {
      float4 v[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        v[s] = *reinterpret_cast<const float4*>(&xs[(g * S + s) * din + k]);
      GRU_ACC4(v, ws, j, az);
      GRU_ACC4(v, ws, H + j, ar);
      GRU_ACC4(v, ws, 2 * H + j, axn);
    }
#pragma unroll 4
    for (int k = 0; k < H; k += 4) {
      float4 v[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        v[s] = *reinterpret_cast<const float4*>(&hsm[(g * S + s) * H + k]);
      GRU_ACC4(v, rs, j, az);
      GRU_ACC4(v, rs, H + j, ar);
      GRU_ACC4(v, rs, 2 * H + j, ahn);
    }
    __syncthreads();  // every read of xs and hsm for this step is done

#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float z = sigmoid(az[s]);
      const float rg = sigmoid(ar[s]);
      const float n = tanhf(axn[s] + rg * (ahn[s] + bh));
      h[s] = (1.0f - z) * n + z * h[s];
      hsm[(g * S + s) * H + j] = h[s];
      const int b = b0 + g * S + s;
      if (hs != nullptr && b < batch) store(&hs[((size_t)t * batch + b) * H + j], h[s]);
    }
  }
  if (h_last != nullptr) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int b = b0 + g * S + s;
      if (b < batch) h_last[(size_t)b * H + j] = h[s];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bzr, const void* r,
                   const void* rbh, void* hs, void* h_last, int t_steps,
                   int batch, int din, int reverse, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)din * G + H * G + (size_t)BS * din + BS * H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + BS - 1) / BS);
  gru_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bzr), static_cast<const float*>(r),
      static_cast<const float*>(rbh), static_cast<T*>(hs),
      static_cast<float*>(h_last), t_steps, batch, din, reverse);
  return cudaGetLastError();
}

}  // namespace

// x [T, B, din] fp32 (bf16 = 0) or bf16 (bf16 = 1); w [din, 192], bzr [192],
// r [64, 192], rbh [64] fp32.  hs [T, B, 64] in x's dtype and/or
// h_last [B, 64] fp32; either may be null.  din % 4 == 0.
extern "C" int gru_fwd(const void* x, const void* w, const void* bzr,
                       const void* r, const void* rbh, void* hs, void* h_last,
                       int t_steps, int batch, int din, int reverse, int bf16,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, w, bzr, r, rbh, hs, h_last, t_steps,
                                   batch, din, reverse, st)
           : launch<float>(x, w, bzr, r, rbh, hs, h_last, t_steps, batch, din,
                           reverse, st);
  return static_cast<int>(err);
}

extern "C" const char* gru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
