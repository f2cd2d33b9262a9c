// GRU cotangent recurrence: the only sequential part of the GRU backward.
//
// Replaces deepreadmapper_tpu/models/gru_pallas.py::_bwd_scan_kernel (via
// _pallas_bwd_scan), which _bwd_manual calls once per GRU call of the
// encoder (4 per encoder batch, 8 per training step).
//
// Inputs, each [T, B, 64] fp32: h_prev (the hidden state before step t), the
// gates z, r, n and gnb = h_prev Rn + rbh recomputed from the forward, and ct
// (the cotangent of the step outputs); rT [192, 64] = R^T.  Outputs dgx, dgh
// [T, B, 192] fp32.  The walk runs against the forward's direction (t = T-1
// .. 0 for a forward GRU, t = 0 .. T-1 for a reverse one; outputs stay in
// their original time positions) and carries lam [B, 64], starting at zero:
//   d = lam + ct_t
//   dz = d (hp - n), dn = d (1 - z), dgn = dn (1 - n^2)
//   dr = dgn gnb, dghn = dgn r, dgz = dz z (1 - z), dgr = dr r (1 - r)
//   dgx_t = [dgz | dgr | dgn], dgh_t = [dgz | dgr | dghn]
//   lam = d z + dgh_t rT
//
// What bounds it on an H100: bytes.  Each sequence and step reads 6 x 64 fp32
// and writes 2 x 192 fp32 (3,072 B) against 192 x 64 multiply-adds for the
// dgh_t rT product, 8 FLOP per byte, below the card's fp32 ridge of ~20.
// What holds it back in practice is the dependence from one step to the
// next: lam of step t feeds step t-1, so every step pays the latency of its
// loads, a 192-deep product and two block barriers.
//
// Design: as in gru_fwd.cu, a block owns GROUPS sequences for all T steps
// (the TPU kernel carries lam in VMEM from one grid step to the next; blocks
// here carry nothing, so the time loop lives inside the block).  Thread
// (j, g) owns hidden unit j of sequence g and keeps its lam in a register.
// rT (48 KB fp32) sits in shared memory for the whole kernel; each step a
// thread publishes its three dgh_t values to shared memory, and after a
// barrier every thread reads the sequence's whole dgh_t row (float4
// broadcasts) against column j of rT (consecutive j, no bank conflicts) in
// three independent 64-deep sums.  The next step's six inputs are loaded
// before this step's product, so their latency overlaps it.  With two
// sequences a block, B = 512 gives 256 blocks for 132 SMs.  Rows past the
// batch read zeros and are never stored.
#include <cuda_runtime.h>

namespace {

constexpr int H = 64;
constexpr int G = 3 * H;
constexpr int GROUPS = 2;                // sequences a block, H threads each
constexpr int THREADS = GROUPS * H;

__global__ void __launch_bounds__(THREADS)
gru_bwd_kernel(const float* __restrict__ hp, const float* __restrict__ zg,
               const float* __restrict__ rg, const float* __restrict__ ng,
               const float* __restrict__ gnb, const float* __restrict__ ct,
               const float* __restrict__ rT, float* __restrict__ dgx,
               float* __restrict__ dgh, int t_steps, int batch, int reverse) {
  extern __shared__ __align__(16) float smem[];
  float* rts = smem;          // [G][H]
  float* dghs = rts + G * H;  // [GROUPS][G]

  const int tid = threadIdx.x;
  const int j = tid % H;
  const int g = tid / H;
  const int b = blockIdx.x * GROUPS + g;  // this thread's sequence

  for (int i = tid; i < G * H; i += THREADS) rts[i] = rT[i];

  // nxt[0..5]: hp, z, r, n, gnb, ct of sequence b at one step
  const float* srcs[6] = {hp, zg, rg, ng, gnb, ct};
  float nxt[6];
  auto load = [&](int t) {
    const bool live = b < batch;
    const size_t off = ((size_t)t * batch + b) * H + j;
#pragma unroll
    for (int a = 0; a < 6; ++a) nxt[a] = live ? srcs[a][off] : 0.0f;
  };

  float lam = 0.0f;
  if (t_steps > 0) load(reverse ? 0 : t_steps - 1);

  for (int step = 0; step < t_steps; ++step) {
    const int t = reverse ? step : t_steps - 1 - step;
    float in[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) in[a] = nxt[a];
    if (step + 1 < t_steps) load(reverse ? step + 1 : t_steps - 2 - step);

    const float h0 = in[0], z = in[1], r = in[2], n = in[3];
    const float d = lam + in[5];
    const float dz = d * (h0 - n);
    const float dn = d * (1.0f - z);
    const float dgn = dn * (1.0f - n * n);
    const float dr = dgn * in[4];
    const float dghn = dgn * r;
    const float dgz = dz * z * (1.0f - z);
    const float dgr = dr * r * (1.0f - r);
    const float dzz = d * z;  // the direct path of lam
    float* row = dghs + g * G;
    row[j] = dgz;
    row[H + j] = dgr;
    row[2 * H + j] = dghn;
    if (b < batch) {
      const size_t o = ((size_t)t * batch + b) * G + j;
      dgx[o] = dgz;
      dgx[o + H] = dgr;
      dgx[o + 2 * H] = dgn;
      dgh[o] = dgz;
      dgh[o + H] = dgr;
      dgh[o + 2 * H] = dghn;
    }
    __syncthreads();  // every dgh_t row of the block is in shared memory

    float az = 0.0f, ar = 0.0f, an = 0.0f;
#pragma unroll 4
    for (int k = 0; k < H; k += 4) {
      float wz[4], wr[4], wn[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wz[q] = rts[(k + q) * H + j];
        wr[q] = rts[(H + k + q) * H + j];
        wn[q] = rts[(2 * H + k + q) * H + j];
      }
      const float* row = dghs + g * G;
      const float4 vz = *reinterpret_cast<const float4*>(row + k);
      const float4 vr = *reinterpret_cast<const float4*>(row + H + k);
      const float4 vn = *reinterpret_cast<const float4*>(row + 2 * H + k);
      az = fmaf(vz.x, wz[0], az);
      az = fmaf(vz.y, wz[1], az);
      az = fmaf(vz.z, wz[2], az);
      az = fmaf(vz.w, wz[3], az);
      ar = fmaf(vr.x, wr[0], ar);
      ar = fmaf(vr.y, wr[1], ar);
      ar = fmaf(vr.z, wr[2], ar);
      ar = fmaf(vr.w, wr[3], ar);
      an = fmaf(vn.x, wn[0], an);
      an = fmaf(vn.y, wn[1], an);
      an = fmaf(vn.z, wn[2], an);
      an = fmaf(vn.w, wn[3], an);
    }
    lam = dzz + (az + ar + an);
    __syncthreads();  // every read of dghs for this step is done
  }
}

}  // namespace

// h_prev, z, r, n, gnb, ct [T, B, 64] fp32; rT [192, 64] fp32; dgx, dgh
// [T, B, 192] fp32.  reverse = 1 for the backward of a reverse-direction
// GRU (the walk runs t = 0 .. T-1).
extern "C" int gru_bwd(const void* h_prev, const void* z, const void* r,
                       const void* n, const void* gnb, const void* ct,
                       const void* rT, void* dgx, void* dgh, int t_steps,
                       int batch, int reverse, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)G * H + (size_t)GROUPS * G);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + GROUPS - 1) / GROUPS);
  gru_bwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h_prev), static_cast<const float*>(z),
      static_cast<const float*>(r), static_cast<const float*>(n),
      static_cast<const float*>(gnb), static_cast<const float*>(ct),
      static_cast<const float*>(rT), static_cast<float*>(dgx),
      static_cast<float*>(dgh), t_steps, batch, reverse);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
