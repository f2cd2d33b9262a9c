// GRU cotangent recurrence: the only sequential part of the GRU backward.
//
// Replaces deepreadmapper_tpu/models/gru_pallas.py::_bwd_scan_kernel (via
// _pallas_bwd_scan), which _bwd_manual calls once per GRU call of the
// encoder (4 per encoder batch, 8 per training step).
//
// Inputs, each [T, B, 64] fp32: h_prev (the hidden state before step t), the
// gates z, r, n and gnb = h_prev Rn + rbh recomputed from the forward, and ct
// (the cotangent of the step outputs); rT [192, 64] = R^T.  Outputs dgx
// [T, B, 192] and dghn [T, B, 64] fp32.  The walk runs against the forward's
// direction (t = T-1 .. 0 for a forward GRU, t = 0 .. T-1 for a reverse one;
// outputs stay in their original time positions) and carries lam [B, 64],
// starting at zero:
//   d = lam + ct_t
//   dz = d (hp - n), dn = d (1 - z), dgn = dn (1 - n^2)
//   dr = dgn gnb, dghn = dgn r, dgz = dz z (1 - z), dgr = dr r (1 - r)
//   dgx_t = [dgz | dgr | dgn], dgh_t = [dgz | dgr | dghn]
//   lam = d z + dgh_t rT
// The JAX kernel also writes dgh_t whole; its first 128 columns are dgx_t's,
// so only dghn is stored here (the caller reads dgh as cat(dgx[..., :128],
// dghn)).
//
// What bounds it on an H100: bytes.  Each sequence and step reads 6 x 64
// fp32 and writes 192 + 64 fp32 (2,560 B) against 192 x 64 multiply-adds
// for the dgh_t rT product, under 10 FLOP per byte, below the card's fp32
// ridge of ~20.  The dependence from one step to the next (lam of step t
// feeds step t-1) means every step also pays the latency of a 192-deep
// product, a cross-lane sum and a block barrier, and at the training batch
// (B = 512) an SM holds only about four sequences to hide it with.  The
// product and its sum are about half of the time, the stores a fifth
// (PERF.md).
//
// Design: a block owns SEQS sequences for all T steps (the TPU kernel
// carries lam in VMEM from one grid step to the next; blocks here carry
// nothing, so the time loop lives inside the block).
//  - The recurrent weights live in registers.  A group of 16 lanes owns
//    four hidden units; lane i holds the 12 rows k = 4 (i + 16 cc) + e
//    (cc < 3, e < 4) of those four columns of rT, 48 weights loaded once.
//    Each dgh_t value a lane reads serves four units, so a lane reads 12
//    values of a row a step (three float4 loads; a lane that owned one
//    unit and 48 rows read four times as much, and took about a fifth longer a
//    step), and one thread serves every sequence of the block with the
//    same weights.  No weight is read from shared memory again.
//  - A step first forms lam for all its sequences (two running sums a
//    unit), so their loads, sums and shuffles overlap; then the
//    elementwise part.
//  - The 16 partial sums of each unit meet by __shfl_xor_sync: a
//    reduce-scatter over lane bits 3 and 2 leaves lane i with unit i / 4,
//    and xor 1, 2 finish the sum, so the four lanes of a unit all hold its
//    lam, bit for bit the same.
//  - The step's dgh_t rows go through shared memory, double-buffered, so one
//    barrier a step suffices.  The lanes of a group read consecutive 16-byte
//    chunks of a row: no bank conflicts.
//  - The six [B, 64] inputs arrive through a cp.async ring STAGES steps
//    deep (16-byte copies, commit/wait groups).  A ragged batch's missing
//    sequences are zero-filled (src-size 0) and never stored.
//  - The four lanes of a unit repeat the elementwise part and split the
//    stores: kq = i % 4 of 0, 1, 2 writes dgz, dgr, dgn into dgx and 3
//    writes dghn; each store instruction of a warp covers four 32-byte
//    sectors.
#include <cuda_runtime.h>

namespace {

constexpr int H = 64;
constexpr int G = 3 * H;
constexpr int UNITS = 4;               // hidden units a thread's weights serve
constexpr int LANES = 16;              // lanes that share those units' product
constexpr int CHUNKS = G / (4 * LANES);  // float4 chunks of a row a lane reads: 3
constexpr int SEQS = 2;                // sequences a block
constexpr int THREADS = H / UNITS * LANES;  // 256
constexpr int NIN = 6;                 // h_prev, z, r, n, gnb, ct
constexpr int STAGES = 4;              // cp.async ring depth, in steps
constexpr int COPIES = NIN * SEQS * H / 4;  // 16-byte copies a step
static_assert(COPIES <= THREADS, "one copy a thread and step");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 16 : 0));
}

__global__ void __launch_bounds__(THREADS, 2)
gru_bwd_kernel(const float* __restrict__ hp, const float* __restrict__ zg,
               const float* __restrict__ rg, const float* __restrict__ ng,
               const float* __restrict__ gnb, const float* __restrict__ ct,
               const float* __restrict__ rT, float* __restrict__ dgx,
               float* __restrict__ dghn, int t_steps, int batch, int reverse) {
  __shared__ __align__(16) float ring[STAGES][NIN][SEQS][H];
  __shared__ __align__(16) float rows[2][SEQS][G];

  const int tid = threadIdx.x;
  const int i = tid % LANES;  // lane in the group of 16
  const int ubase = tid / LANES * UNITS;
  const bool hi8 = i & 8, hi4 = i & 4;
  const int j = ubase + i / 4;  // the unit this lane finishes
  const int kq = i % 4;         // and which of its outputs it stores

  float w[CHUNKS][UNITS][4];  // rT[4 (i + 16 cc) + e][ubase + u] at w[cc][u][e]
#pragma unroll
  for (int cc = 0; cc < CHUNKS; ++cc)
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[cc][u][e] = rT[(4 * (i + LANES * cc) + e) * H + ubase + u];

  // This thread's copy each step: input ca, sequence cs, floats 4cp..4cp+3.
  const int b0 = blockIdx.x * SEQS;
  const int ca = tid / (SEQS * 16), cs = tid / 16 % SEQS, cp = tid % 16;
  const bool copier = tid < COPIES;
  const bool clive = copier && b0 + cs < batch;
  const float* csrc = (ca == 0 ? hp : ca == 1 ? zg : ca == 2 ? rg : ca == 3 ? ng
                       : ca == 4 ? gnb : ct) + (size_t)(b0 + cs) * H + 4 * cp;
  auto issue = [&](int step) {  // always commits, so each step is one group
    if (copier) {
      const bool live = clive && step < t_steps;
      const size_t toff = (size_t)(reverse ? step : t_steps - 1 - step) * batch * H;
      cp_async16(&ring[step % STAGES][ca][cs][4 * cp], live ? csrc + toff : hp, live);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // this lane's output: dgx column kq * 64 + j (kq < 3) or dghn column j
  float* const out = kq < 3 ? dgx + kq * H + j : dghn + j;
  const int ostride = kq < 3 ? G : H;

  float dzz[SEQS];  // d z of the previous step: the direct path of lam
#pragma unroll
  for (int s = 0; s < SEQS; ++s) dzz[s] = 0.0f;

  for (int step = 0; step < t_steps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    // this step's inputs are in the ring; the previous step's dgh rows are
    // in rows[(step - 1) & 1]; every read of ring slot (step - 1) % STAGES
    // and of rows[step & 1] is done
    __syncthreads();
    issue(step + STAGES - 1);

    const int t = reverse ? step : t_steps - 1 - step;
    const float* prev = &rows[(step + 1) & 1][0][0];
    float* cur = &rows[step & 1][0][0];
    // lam of every sequence first: the sequences' loads, sums and shuffles
    // are independent, and no shared store sits between them
    float lam[SEQS];
#pragma unroll
    for (int s = 0; s < SEQS; ++s) lam[s] = 0.0f;
    if (step > 0) {
      float p[SEQS][UNITS][2] = {};  // two running sums a unit: x, y and z, w
#pragma unroll
      for (int cc = 0; cc < CHUNKS; ++cc)
#pragma unroll
        for (int s = 0; s < SEQS; ++s) {
          const float4 v =
              *reinterpret_cast<const float4*>(prev + s * G + 4 * (i + LANES * cc));
#pragma unroll
          for (int u = 0; u < UNITS; ++u) {
            p[s][u][0] = fmaf(v.x, w[cc][u][0], p[s][u][0]);
            p[s][u][1] = fmaf(v.z, w[cc][u][2], p[s][u][1]);
            p[s][u][0] = fmaf(v.y, w[cc][u][1], p[s][u][0]);
            p[s][u][1] = fmaf(v.w, w[cc][u][3], p[s][u][1]);
          }
        }
#pragma unroll
      for (int s = 0; s < SEQS; ++s) {
        float q[UNITS];
#pragma unroll
        for (int u = 0; u < UNITS; ++u) q[u] = p[s][u][0] + p[s][u][1];
        // reduce-scatter over lane bits 3 and 2 (units 2 bit3 + bit2),
        // then sum over bits 1 and 0
        const float r0 = __shfl_xor_sync(0xffffffffu, hi8 ? q[0] : q[2], 8);
        const float r1 = __shfl_xor_sync(0xffffffffu, hi8 ? q[1] : q[3], 8);
        const float k0 = (hi8 ? q[2] : q[0]) + r0;
        const float k1 = (hi8 ? q[3] : q[1]) + r1;
        float v = (hi4 ? k1 : k0) + __shfl_xor_sync(0xffffffffu, hi4 ? k0 : k1, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        lam[s] = dzz[s] + v;
      }
    }
#pragma unroll
    for (int s = 0; s < SEQS; ++s) {
      const float* in = &ring[step % STAGES][0][s][j];  // input a at in[a * SEQS * H]
      const float h0 = in[0], z = in[SEQS * H], r = in[2 * SEQS * H];
      const float n = in[3 * SEQS * H], gb = in[4 * SEQS * H], c = in[5 * SEQS * H];
      const float d = lam[s] + c;
      const float dz = d * (h0 - n);
      const float dn = d * (1.0f - z);
      const float dgn = dn * (1.0f - n * n);
      const float dr = dgn * gb;
      const float dgh_n = dgn * r;
      const float dgz = dz * z * (1.0f - z);
      const float dgr = dr * r * (1.0f - r);
      dzz[s] = d * z;
      // lane kq publishes dgh_t column kq * 64 + j (kq 3: the n part)
      if (kq != 2) cur[s * G + (kq == 3 ? 2 : kq) * H + j] = kq == 0 ? dgz : kq == 1 ? dgr : dgh_n;
      if (b0 + s < batch)
        out[((size_t)t * batch + b0 + s) * ostride] =
            kq == 0 ? dgz : kq == 1 ? dgr : kq == 2 ? dgn : dgh_n;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // leave no copy in flight
}

}  // namespace

// h_prev, z, r, n, gnb, ct [T, B, 64] fp32 (16-byte aligned); rT [192, 64]
// fp32; dgx [T, B, 192], dghn [T, B, 64] fp32.  reverse = 1 for the backward
// of a reverse-direction GRU (the walk runs t = 0 .. T-1).
extern "C" int gru_bwd(const void* h_prev, const void* z, const void* r,
                       const void* n, const void* gnb, const void* ct,
                       const void* rT, void* dgx, void* dghn, int t_steps,
                       int batch, int reverse, void* stream) {
  const dim3 grid((batch + SEQS - 1) / SEQS);
  gru_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h_prev), static_cast<const float*>(z),
      static_cast<const float*>(r), static_cast<const float*>(n),
      static_cast<const float*>(gnb), static_cast<const float*>(ct),
      static_cast<const float*>(rT), static_cast<float*>(dgx),
      static_cast<float*>(dghn), t_steps, batch, reverse);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
