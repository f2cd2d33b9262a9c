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
// What bounds it on an H100: the step products, (din + 64) x 192
// multiply-adds per sequence and step, about 96 FLOP per byte of fp32 x in
// layer 1, so device memory is far from the limit.  They run on the tensor
// cores as TF32 mma.sync (m16n8k8), in three passes per product so that the
// result keeps fp32 accuracy: v = hi + lo with hi = v rounded to nearest
// TF32 and lo = v - hi, and A B ~ Ahi Bhi + Ahi Blo + Alo Bhi.  One TF32 pass
// alone is off by ~4e-4 on the shipped two-layer encoder at T = 123 (layer 1
// hs and the embedding), past the 1e-4 the port holds the kernel to; three
// passes are off by ~1e-6 (tests/test_torch_gru.py emulates both on the
// CPU).  bf16 x is exact in TF32 (x_lo = 0): its x W takes two passes.  So
// are the shipped weights, which come from fp16 (w_lo = r_lo = 0), so on
// serving two passes would give the same sums; the kernel splits the weights
// all the same, since fine-tuning makes them fp32.  The bound counts the
// passes the inputs need (chip_smoke.py) at the dense TF32 rate.
//
// The split costs ALU instructions beside every product, and they, not the
// tensor cores, set the pace: cvt.rna.tf32.f32 is emulated on sm_90 (an inf
// check, an add, a select and a mask), so hi is rounded with an integer add
// and mask (the same rounding for finite values), and lo goes to mma.sync
// unrounded (the tensor core reads its top 19 bits; lo = v - hi is exact and
// its sign is random, so the truncation adds no bias).  The gates use the
// fast exp and divide for the same reason.
//
// mma.sync's fp32 accumulation is coarser than an fp32 add: a gate's sum run
// through all 48-72 of its mma.sync in one accumulator drifts about ten
// times further from the plain version than the FFMA kernel did, enough to
// move a read's SW top-1 at the 200 kbp size chip_smoke.py checks.  So each
// gate's passes of two k-slices go into a fresh partial, and an fp32 add
// carries the running sum.
//
// Design: the TPU kernel walks time in the grid's inner dimension and carries
// h in VMEM scratch from one grid step to the next.  Blocks on Hopper run in
// no order and carry nothing, so here each block owns BS = 16 sequences (one
// m16 tile) and loops over all T steps itself (forward or reverse by index;
// outputs land in their original time positions).  Each step it computes
// [x_t | h] [W ; R] with 8 warps; warp w owns hidden units 8w .. 8w + 7, one
// n8 tile in each of the z, r and n column ranges, so the z, r and n sums of
// one (sequence, unit) sit in the same register of the same thread and the
// gate math and carry update are thread-local (4 h values a thread).  The
// n gate keeps its x and h sums apart (r scales only the h part).
//   W and R stay in shared memory as fp32 for the whole kernel (din = 128:
//   144 KB) and each weight fragment is split into hi/lo as it is loaded
//   (a pre-split layout would not fit); the x and h fragments are split once
//   per k-slice and reused by the warp's three n tiles.  W and R columns are
//   XOR-swizzled by row (col ^ 8 (k & 3)) and the h tile by row
//   (col ^ 4 (row & 7)), and x rows are padded by 16 bytes, so every fragment
//   read is free of bank conflicts without padding the weights.
//   h is double-buffered in shared memory and x_{t+1} is prefetched with
//   cp.async into the other half of a double-buffered x tile while step t
//   computes, so each step has one barrier.  The ragged batch edge reads
//   zeros (cp.async with source size 0) and is never stored.  din = 64 fp32
//   needs 112.5 KB, so two blocks share an SM and each is held to 128
//   registers; din = 128 needs 168.5 KB, one block an SM, built without
//   that cap (it runs faster with the ~156 registers it takes).
// Inputs are fp32 or bf16; gate math and the carry are fp32, per-step
// outputs are in the input dtype, h_last fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 64;
constexpr int G = 3 * H;
constexpr int BS = 16;                  // sequences per block: one m16 tile
constexpr int WARPS = H / 8;            // warp w owns hidden units 8w .. 8w + 7
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * v));
}

// v = hi + lo: hi is v rounded to nearest TF32 (ties away from zero, as
// cvt.rna.tf32.f32), lo = v - hi exactly, left for mma.sync to truncate
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile: a rows (g, g + 8) x cols (t, t + 4),
// b rows (t, t + 4) x col g, d rows (g, g + 8) x cols (2t, 2t + 1)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B from three TF32 passes; b0, b1 are the fp32 weights of this
// lane's B fragment.  A_EXACT: A is TF32 already (alo = 0).
template <bool A_EXACT>
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  if (!A_EXACT) mma(acc, alo, bh0, bh1);
  mma(acc, ahi, bl0, bl1);
  mma(acc, ahi, bh0, bh1);
}

// acc += part in fp32; part = 0
__device__ __forceinline__ void flush(float (&acc)[4], float (&part)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i] += part[i];
    part[i] = 0.0f;
  }
}

// 16-byte (fp32) or 8-byte (bf16) copy of 4 elements; src_bytes 0 writes zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// shared memory: W [kpad][G] and R [H][G] swizzled, the x tile [2][BS][xs]
// (xs = din + 16 bytes of pad, in In), the h tile [2][BS][H] swizzled
template <typename In>
__host__ __device__ constexpr int x_stride(int din) {
  return din + 16 / static_cast<int>(sizeof(In));
}
__host__ __device__ constexpr int k_pad(int din) { return (din + 7) & ~7; }

// MIN_BLOCKS: blocks an SM holds at this din (the register cap follows it)
template <typename In, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gru_fwd_kernel(const In* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bzr, const float* __restrict__ r,
               const float* __restrict__ rbh, In* __restrict__ hs,
               float* __restrict__ h_last, int t_steps, int batch, int din,
               int reverse) {
  constexpr bool X_EXACT = sizeof(In) == 2;  // bf16 fits in TF32
  constexpr int CHUNK = 4;                   // elements per cp.async
  constexpr int BYTES = CHUNK * static_cast<int>(sizeof(In));
  extern __shared__ __align__(16) float smem[];
  const int kpad = k_pad(din);
  const int xs = x_stride<In>(din);
  float* ws = smem;                                    // [kpad][G]
  float* rs = ws + kpad * G;                           // [H][G]
  float* hb = rs + H * G;                              // [2][BS][H]
  In* xb = reinterpret_cast<In*>(hb + 2 * BS * H);     // [2][BS][xs]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b0 = blockIdx.x * BS;
  const int rows = min(BS, batch - b0);

  for (int i = tid; i < kpad * G; i += THREADS) {
    const int k = i / G, n = i % G;
    ws[k * G + (n ^ ((k & 3) << 3))] = k < din ? w[i] : 0.0f;
  }
  for (int i = tid; i < H * G; i += THREADS) {
    const int k = i / G, n = i % G;
    rs[k * G + (n ^ ((k & 3) << 3))] = r[i];
  }
  for (int i = tid; i < 2 * BS * H; i += THREADS) hb[i] = 0.0f;
  for (int i = tid; i < 2 * BS * (xs - din); i += THREADS)  // pad columns
    xb[(i / (xs - din)) * xs + din + i % (xs - din)] = In(0.0f);

  // this thread copies chunks tid, tid + THREADS, ... of the BS x chunks
  // tile; (row, chunk) advances by (drow, dc) with a carry, no division
  const int chunks = din / CHUNK;  // per row
  const int row0 = tid / chunks, c0 = tid % chunks;
  const int drow = THREADS / chunks, dc = THREADS % chunks;
  auto prefetch = [&](int step, In* dst) {
    const int t = reverse ? t_steps - 1 - step : step;
    const In* src = x + ((size_t)t * batch + b0) * din;
    for (int row = row0, c = c0; row < BS; row += drow, c += dc) {
      if (c >= chunks) {
        c -= chunks;
        if (++row >= BS) break;
      }
      const bool in = row < rows;
      cp_async<BYTES>(dst + row * xs + c * CHUNK, in ? src + row * din + c * CHUNK : x,
                      in ? BYTES : 0);
    }
    cp_async_commit();
  };
  prefetch(0, xb);

  // this lane's hidden units j0, j0 + 1; accumulator i is row g + 8 (i >> 1),
  // unit j0 + (i & 1)
  const int j0 = 8 * wp + 2 * t4;
  const float bz[2] = {bzr[j0], bzr[j0 + 1]};
  const float br[2] = {bzr[H + j0], bzr[H + j0 + 1]};
  const float bn[2] = {bzr[2 * H + j0], bzr[2 * H + j0 + 1]};
  const float bh[2] = {rbh[j0], rbh[j0 + 1]};
  const int wcol = 8 * (wp ^ t4) + g;  // swizzled B column in rows k0 + t4 (+ 4)
  const int hsw = 4 * g;               // h tile swizzle of rows g and g + 8
  float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int step = 0; step < t_steps; ++step) {
    const int t = reverse ? t_steps - 1 - step : step;
    const int cur = step & 1;
    cp_async_wait_all();  // this thread's part of x_t has landed
    __syncthreads();      // all of x_t and the last step's h are in; the
                          // other halves of both tiles are free again
    if (step + 1 < t_steps) prefetch(step + 1, xb + (cur ^ 1) * BS * xs);

    // fp32 sums (the bias first), and the tensor-core partials of up to two
    // k-slices that are flushed into them
    float az[4], ar[4], axn[4], ahn[4], pz[4], pr[4], pn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      az[i] = bz[i & 1];
      ar[i] = br[i & 1];
      axn[i] = bn[i & 1];
      ahn[i] = pz[i] = pr[i] = pn[i] = 0.0f;
    }
    // x_t W: k-slices of 8 inputs
    const In* xa = xb + cur * BS * xs + g * xs + t4;
#pragma unroll 2
    for (int k0 = 0; k0 < kpad; k0 += 8) {
      const float a[4] = {to_float(xa[k0]), to_float(xa[8 * xs + k0]),
                          to_float(xa[k0 + 4]), to_float(xa[8 * xs + k0 + 4])};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (X_EXACT) {
          ahi[i] = __float_as_uint(a[i]);
          alo[i] = 0u;
        } else {
          split(a[i], ahi[i], alo[i]);
        }
      }
      const float* wk = ws + (k0 + t4) * G + wcol;
      mma3<X_EXACT>(pz, ahi, alo, wk[0], wk[4 * G]);
      mma3<X_EXACT>(pr, ahi, alo, wk[H], wk[4 * G + H]);
      mma3<X_EXACT>(pn, ahi, alo, wk[2 * H], wk[4 * G + 2 * H]);
      if ((k0 & 8) || k0 + 8 == kpad) {  // every second slice, and the last
        flush(az, pz);
        flush(ar, pr);
        flush(axn, pn);
      }
    }
    // h R
    const float* ha = hb + cur * BS * H + g * H;
#pragma unroll
    for (int k0 = 0; k0 < H; k0 += 8) {
      const int c0 = (k0 + t4) ^ hsw, c1 = (k0 + t4 + 4) ^ hsw;
      const float a[4] = {ha[c0], ha[8 * H + c0], ha[c1], ha[8 * H + c1]};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a[i], ahi[i], alo[i]);
      const float* rk = rs + (k0 + t4) * G + wcol;
      mma3<false>(pz, ahi, alo, rk[0], rk[4 * G]);
      mma3<false>(pr, ahi, alo, rk[H], rk[4 * G + H]);
      mma3<false>(pn, ahi, alo, rk[2 * H], rk[4 * G + 2 * H]);
      if (k0 & 8) {
        flush(az, pz);
        flush(ar, pr);
        flush(ahn, pn);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float z = sigmoid(az[i]);
      const float rg = sigmoid(ar[i]);
      const float n = tanh_fast(axn[i] + rg * (ahn[i] + bh[i & 1]));
      h[i] = (1.0f - z) * n + z * h[i];
    }
    float* hn = hb + (cur ^ 1) * BS * H + g * H + (j0 ^ hsw);
    store2(hn, h[0], h[1]);
    store2(hn + 8 * H, h[2], h[3]);
    if (hs != nullptr) {
      In* out = hs + ((size_t)t * batch + b0 + g) * H + j0;
      if (g < rows) store2(out, h[0], h[1]);
      if (g + 8 < rows) store2(out + 8 * H, h[2], h[3]);
    }
  }
  if (h_last != nullptr) {
    float* out = h_last + (size_t)(b0 + g) * H + j0;
    if (g < rows) store2(out, h[0], h[1]);
    if (g + 8 < rows) store2(out + 8 * H, h[2], h[3]);
  }
}

template <typename In, int MIN_BLOCKS>
cudaError_t launch_kernel(const void* x, const void* w, const void* bzr, const void* r,
                          const void* rbh, void* hs, void* h_last, int t_steps,
                          int batch, int din, int reverse, size_t smem,
                          cudaStream_t stream) {
  auto* kernel = gru_fwd_kernel<In, MIN_BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + BS - 1) / BS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const In*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bzr), static_cast<const float*>(r),
      static_cast<const float*>(rbh), static_cast<In*>(hs),
      static_cast<float*>(h_last), t_steps, batch, din, reverse);
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch(const void* x, const void* w, const void* bzr, const void* r,
                   const void* rbh, void* hs, void* h_last, int t_steps,
                   int batch, int din, int reverse, cudaStream_t stream) {
  // cp.async moves 4 elements at a time from 4-element-aligned rows
  if (din < 4 || din % 4 || reinterpret_cast<uintptr_t>(x) % (4 * sizeof(In)))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)k_pad(din) * G + H * G + 2 * BS * H) +
                      sizeof(In) * 2 * BS * x_stride<In>(din);
  // two blocks an SM where their shared memory fits (din = 64), else one
  // block free of the 128-register cap that two would impose
  return 2 * smem <= 227 * 1024
             ? launch_kernel<In, 2>(x, w, bzr, r, rbh, hs, h_last, t_steps, batch,
                                    din, reverse, smem, stream)
             : launch_kernel<In, 1>(x, w, bzr, r, rbh, hs, h_last, t_steps, batch,
                                    din, reverse, smem, stream);
}

}  // namespace

// x [T, B, din] fp32 (bf16 = 0) or bf16 (bf16 = 1); w [din, 192], bzr [192],
// r [64, 192], rbh [64] fp32.  hs [T, B, 64] in x's dtype and/or
// h_last [B, 64] fp32; either may be null.  din > 0, din % 4 == 0, x
// aligned to 4 elements.
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
