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
//    stores), and sum its exact norm with __dp4a on the rebuilt words.
//  - The slab is double-buffered: the rebuild of slab i+1 and the products
//    of slab i sit between the same two barriers, one barrier a slab.
//  - Scores are int8 tensor-core products, mma.sync m16n8k32 (s8 x s8 ->
//    s32): the slab's rows are A, the queries B.  The warps form 2 x 4
//    tiles of 64 rows x 32 queries; each warp holds its queries' B
//    fragments in 32 registers for the whole block and reads the rows' A
//    fragments with ldmatrix (one x4 per 16 rows and 32-byte k-step; the
//    144-byte row pitch keeps the eight rows of a phase on distinct banks).
//    A warp reads 64 of the slab's 128 rows, half of what a whole-slab
//    warp tile would.
//  - Each thread folds its accumulator rows into a running (min, row) per
//    query column, rows in ascending order with a strict '<'.  The int32
//    sum turns into fp32 by an exponent-bias add rather than a
//    quarter-rate conversion.  This fold, a handful of instructions for
//    every score, costs more than the products.  At a window's end the
//    eight lanes that share a query column take the lexicographic minimum
//    of (score, row) by __shfl_xor_sync (xor 4, 8, 16), and the two row
//    halves meet through shared memory after the next barrier.  The
//    lexicographic minimum over partial scans equals the sequential
//    strict-'<' scan: the lowest row among the minima wins, as
//    scan_kernel._winmin requires.  A window of w > 128 rows carries its
//    running (min, row) across slabs.  Rows at or past ntotal take the norm
//    3.4e38, which no product moves, so a window that is masked whole
//    returns (3.4e38, its first row).
#include <climits>

#include "winmin.cuh"

namespace {

using winmin::BIG;
using winmin::D;
using winmin::SLAB;

constexpr int QB = 128;               // queries a block
constexpr int WPB = 32;               // windows a block
constexpr int WARPS = 8;              // 2 row halves x 4 query quarters
constexpr int THREADS = 32 * WARPS;
constexpr int MT = SLAB / 2 / 16;     // m16 tiles a warp covers: 64 rows
constexpr int NT = QB / 4 / 8;        // n8 tiles a warp covers: 32 queries
constexpr int KS = D / 32;            // k32 steps of a row
constexpr int NCOL = 2 * NT;          // query columns a thread holds
constexpr int PITCH = D + 16;         // staged row pitch, bytes
constexpr int CB_BYTES_MAX = 256 * D;  // ksub <= 256 entries of 128 B
constexpr int M_MAX = 32;             // 128 / m a multiple of 4
static_assert(THREADS == 2 * SLAB, "two threads rebuild each slab row");
static_assert(THREADS >= SLAB * M_MAX / 16, "one codes copy a thread and slab");

constexpr size_t SLAB_BYTES = 2 * SLAB * PITCH;  // double-buffered
constexpr size_t RED_BYTES = 2 * 2 * QB * 8;      // [window parity][half][query] (min, row)
constexpr size_t RN_BYTES = 2 * SLAB * 4;

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Exact int -> fp32 for |v| < 2^22: 1.5 * 2^23 + v has unit spacing.
__device__ __forceinline__ float exact_float(int v) {
  return __int_as_float(v + 0x4B400000) - 12582912.0f;
}

// The score of a row, rounded once in fp32 as the plain version does.
__device__ __forceinline__ float score(int acc, float rn, float ratio2) {
  return __fmaf_rn(-ratio2, exact_float(acc), rn);
}

__global__ void __launch_bounds__(THREADS, 2)
pq_winmin_kernel(const int8_t* __restrict__ q8, const uint8_t* __restrict__ codes,
                 const int8_t* __restrict__ cent8, float* __restrict__ vals,
                 int* __restrict__ args, int qp, int nwin, int w, int ntotal,
                 float ratio2, int m, int ksub) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* slab = smem;                                 // [2][SLAB][PITCH]
  float* redv = reinterpret_cast<float*>(smem + SLAB_BYTES);  // [2][2][QB]
  int* redr = reinterpret_cast<int*>(redv + 2 * 2 * QB);      // [2][2][QB]
  float* rn = reinterpret_cast<float*>(redr + 2 * 2 * QB);    // [2][SLAB]
  int* cb = reinterpret_cast<int*>(rn + 2 * SLAB);            // [m][ksub][128/m] int8
  uint8_t* cds = reinterpret_cast<uint8_t*>(cb) + ksub * D;   // [2][SLAB][m]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 2, wq = warp & 3;
  const int spw = w / SLAB;  // slabs a window
  const int win0 = blockIdx.y * WPB;
  const int nslab = (min(win0 + WPB, nwin) - win0) * spw;
  const size_t row_first = (size_t)win0 * w;
  const int qbase = blockIdx.x * QB;

  auto issue_codes = [&](int s) {  // codes of local slab s into slot s & 1
    if (s < nslab && tid < SLAB * m / 16) {
      const uint8_t* src = codes + (row_first + (size_t)s * SLAB) * m + 16 * tid;
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(cds + (s & 1) * SLAB * m + 16 * tid));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  issue_codes(0);
  issue_codes(1);

  {  // the codebook, once
    const int4* src = reinterpret_cast<const int4*>(cent8);
    int4* dst = reinterpret_cast<int4*>(cb);
    for (int i = tid; i < ksub * D / 16; i += THREADS) dst[i] = src[i];
  }
  // this warp's queries as B fragments: query qbase + wq*32 + nt*8 + g,
  // bytes 32kk + 4t .. +3 and 32kk + 16 + 4t .. +3
  unsigned bq[NT][KS][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int* qrow = reinterpret_cast<const int*>(
        q8 + (size_t)(qbase + wq * 32 + nt * 8 + g) * D);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      bq[nt][kk][0] = qrow[8 * kk + t];
      bq[nt][kk][1] = qrow[8 * kk + 4 + t];
    }
  }

  const int sh = __ffs((D / 4) / m) - 1;  // log2 of codebook words an entry
  const int dsw = 1 << sh;
  // Rebuild local slab s into buffer s & 1: thread tid writes 16-byte
  // chunks 4h .. 4h+3 of row r and the pair sums the row's norm.
  auto rebuild = [&](int s) {
    const int r = tid >> 1, h = tid & 1;
    const uint8_t* rc = cds + (s & 1) * SLAB * m + r * m;
    int4* dst = reinterpret_cast<int4*>(slab + ((s & 1) * SLAB + r) * PITCH);
    int nrm = 0;
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      const int c = 4 * h + k4;
      int4 v;
      if (dsw >= 4) {  // the chunk lies in one subspace entry
        const int j = (4 * c) >> sh;
        v = *reinterpret_cast<const int4*>(cb + ((j * ksub + rc[j]) << sh) + (4 * c & (dsw - 1)));
      } else {
        int e[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int wd = 4 * c + k, j = wd >> sh;
          e[k] = cb[((j * ksub + rc[j]) << sh) + (wd & (dsw - 1))];
        }
        v = make_int4(e[0], e[1], e[2], e[3]);
      }
      nrm = __dp4a(v.x, v.x, nrm);
      nrm = __dp4a(v.y, v.y, nrm);
      nrm = __dp4a(v.z, v.z, nrm);
      nrm = __dp4a(v.w, v.w, nrm);
      dst[c] = v;
    }
    nrm += __shfl_xor_sync(0xffffffffu, nrm, 1);
    const size_t row = row_first + (size_t)s * SLAB + r;
    if (h == 0) rn[(s & 1) * SLAB + r] = row < (size_t)max(ntotal, 0) ? (float)nrm : BIG;
  };
  // The two row halves of window wl meet: (min, lowest row) per query.
  auto combine = [&](int wl) {
    if (tid < QB) {
      const int p = wl & 1;
      const float v0 = redv[(p * 2) * QB + tid], v1 = redv[(p * 2 + 1) * QB + tid];
      const int r0 = redr[(p * 2) * QB + tid], r1 = redr[(p * 2 + 1) * QB + tid];
      const bool one = v1 < v0 || (v1 == v0 && r1 < r0);
      const size_t o = (size_t)(win0 + wl) * qp + qbase + tid;
      vals[o] = one ? v1 : v0;
      args[o] = one ? r1 : r0;
    }
  };

  asm volatile("cp.async.wait_group 1;\n" ::);
  __syncthreads();  // the codebook and slab 0's codes are in shared memory
  rebuild(0);

  float best[NCOL];
  int arg[NCOL];
#pragma unroll
  for (int col = 0; col < NCOL; ++col) {
    best[col] = INFINITY;
    arg[col] = 0;
  }
  const unsigned slab_s = static_cast<unsigned>(__cvta_generic_to_shared(slab));
  // ldmatrix row of this lane: matrix lane >> 3 is rows +0/+8, bytes +0/+16
  const unsigned lm_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + (lane >> 4) * 16;

  for (int s = 0; s < nslab; ++s) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    // slab s and its norms are staged, slab s+1's codes have arrived, and
    // every read of buffer (s+1) & 1, of codes slot s & 1 and of the
    // window sums of window s / spw - 2 is done
    __syncthreads();
    if (s > 0 && s % spw == 0) combine(s / spw - 1);
    issue_codes(s + 2);
    if (s + 1 < nslab) rebuild(s + 1);

    const int buf = s & 1;
    const size_t row0 = row_first + (size_t)s * SLAB;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int rbase = wr * (SLAB / 2) + mt * 16;
      unsigned a[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(a[kk], slab_s + (buf * SLAB + rbase) * PITCH + lm_off + 32 * kk);
      int acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) mma_s8(acc[nt], a[kk], bq[nt][kk][0], bq[nt][kk][1]);
      }
      const float rn0 = rn[buf * SLAB + rbase + g], rn1 = rn[buf * SLAB + rbase + g + 8];
      const int row_g = (int)(row0 + rbase + g);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // column 2t + e: row g, then row g + 8
          const int col = 2 * nt + e;
          const float s0 = score(acc[nt][e], rn0, ratio2);
          if (s0 < best[col]) {
            best[col] = s0;
            arg[col] = row_g;
          }
          const float s1 = score(acc[nt][2 + e], rn1, ratio2);
          if (s1 < best[col]) {
            best[col] = s1;
            arg[col] = row_g + 8;
          }
        }
    }

    if ((s + 1) % spw == 0) {  // window s / spw ends: fold the warp's lanes
      const int p = (s / spw) & 1;
#pragma unroll
      for (int col = 0; col < NCOL; ++col) {
        float v = best[col];
#pragma unroll
        for (int x = 4; x < 32; x *= 2) {
          const float o = __shfl_xor_sync(0xffffffffu, v, x);
          v = o < v ? o : v;
        }
        int r = best[col] == v ? arg[col] : INT_MAX;
        r = min(r, __shfl_xor_sync(0xffffffffu, r, 4));
        r = min(r, __shfl_xor_sync(0xffffffffu, r, 8));
        r = min(r, __shfl_xor_sync(0xffffffffu, r, 16));
        if (g == 0) {
          const int q = wq * 32 + (col >> 1) * 8 + 2 * t + (col & 1);
          redv[(p * 2 + wr) * QB + q] = v;
          redr[(p * 2 + wr) * QB + q] = r;
        }
        best[col] = INFINITY;
        arg[col] = 0;
      }
    }
  }
  __syncthreads();
  if (nslab > 0) combine(nslab / spw - 1);
}

}  // namespace

// q8 [qp, 128] int8, codes [np, m] uint8 (each < ksub), cent8 [m, ksub,
// 128/m] int8, codes and cent8 16-byte aligned -> vals, args [np / w, qp]
// (f32, i32).
// qp % 128 == 0, w % 128 == 0, np % w == 0, 128 / m a multiple of 4,
// ksub <= 256.
extern "C" int pq_winmin(const void* q8, const void* codes, const void* cent8,
                         void* vals, void* args, int qp, int np, int w,
                         int ntotal, float ratio2, int m, int ksub,
                         void* stream) {
  const size_t smem = SLAB_BYTES + RED_BYTES + RN_BYTES + (size_t)ksub * D +
                      (size_t)2 * SLAB * m;
  static_assert(SLAB_BYTES + RED_BYTES + RN_BYTES + CB_BYTES_MAX + 2 * SLAB * M_MAX <=
                    227 * 1024, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      pq_winmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nwin = np / w;
  const dim3 grid(qp / QB, (nwin + WPB - 1) / WPB);
  pq_winmin_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const uint8_t*>(codes),
      static_cast<const int8_t*>(cent8), static_cast<float*>(vals),
      static_cast<int*>(args), qp, nwin, w, ntotal, ratio2, m, ksub);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pq_winmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
