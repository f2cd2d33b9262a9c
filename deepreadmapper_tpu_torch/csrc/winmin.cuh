// Shared parts of the int8 scans (int8_winmin.cu, pq_winmin.cu, ivf_chunk.cu).
//
// Scores are s = rn - ratio2 * (q . r): the int8 dot product is exact in
// int32, and the score is rounded ONCE, as an explicit __fmaf_rn, which is
// what the JAX package computes (XLA fuses the expression into one FMA).
//
// The window-min scan block (namespace scan) is the design of the two
// fused window-min scans: a block of 8 warps owns QB = 128 queries and WPB =
// 32 consecutive windows of W rows and walks their rows in 128-row slabs
// staged in shared memory at a 144-byte pitch.
//  - Scores are int8 tensor-core products, mma.sync m16n8k32 (s8 x s8 ->
//    s32): the slab's rows are A, the queries B.  The warps form 2 x 4
//    tiles of 64 rows x 32 queries; each warp holds its queries' B
//    fragments in 32 registers for the whole block and reads the rows' A
//    fragments with ldmatrix (one x4 per 16 rows and 32-byte k-step; the
//    144-byte pitch keeps the eight rows of a phase on distinct banks).
//  - Each thread folds its accumulator rows into a running (min, row) per
//    query column, rows in ascending order with a strict '<'.  The int32
//    sum turns into fp32 by an exponent-bias add rather than a
//    quarter-rate conversion.  At a window's end the eight lanes that share
//    a query column take the lexicographic minimum of (score, row) by
//    __shfl_xor_sync (xor 4, 8, 16), and the two row halves meet through
//    shared memory after the next barrier.  The lexicographic minimum over
//    partial scans equals the sequential strict-'<' scan: the lowest row
//    among the minima wins, as scan_kernel._winmin requires.  A window of
//    w > 128 rows carries its running (min, row) across slabs.  Rows at or
//    past ntotal take the norm 3.4e38, which no product moves, so a window
//    that is masked whole returns (3.4e38, its first row).
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace winmin {

constexpr int D = 128;                // bytes per row (embedding dim)
constexpr int V = D / 16;             // int4 vectors per row
constexpr int SLAB = 128;             // rows staged in shared memory at once
constexpr float BIG = 3.4e38f;

__device__ __forceinline__ int dot16(const int4 a, const int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

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

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Exact int -> fp32 for |v| < 2^22: 1.5 * 2^23 + v has unit spacing.
// |q . r| <= 128^3 = 2^21 for int8 rows.
__device__ __forceinline__ float exact_float(int v) {
  return __int_as_float(v + 0x4B400000) - 12582912.0f;
}

// The score of a row, rounded once in fp32 as the plain version does.
__device__ __forceinline__ float score(int acc, float rn, float ratio2) {
  return __fmaf_rn(-ratio2, exact_float(acc), rn);
}

// ldmatrix.x4 row of this lane for an m16 x k32 A tile at a PITCH-byte
// row pitch: matrix lane >> 3 is rows +0/+8, bytes +0/+16.
__device__ __forceinline__ unsigned ldmatrix_offset(int lane, int pitch) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * pitch + (lane >> 4) * 16;
}

namespace scan {

constexpr int QB = 128;               // queries a block
constexpr int WPB = 32;               // windows a block
constexpr int WARPS = 8;              // 2 row halves x 4 query quarters
constexpr int THREADS = 32 * WARPS;
constexpr int MT = SLAB / 2 / 16;     // m16 tiles a warp covers: 64 rows
constexpr int NT = QB / 4 / 8;        // n8 tiles a warp covers: 32 queries
constexpr int KS = D / 32;            // k32 steps of a row
constexpr int NCOL = 2 * NT;          // query columns a thread holds
constexpr int PITCH = D + 16;         // staged row pitch, bytes
constexpr size_t RED_BYTES = 2 * 2 * QB * 8;  // [window parity][half][query] (min, row)

// This warp's queries as B fragments: query qbase + wq*32 + nt*8 + g,
// bytes 32kk + 4t .. +3 and 32kk + 16 + 4t .. +3.
__device__ __forceinline__ void load_queries(const int8_t* q8, int qbase, int wq, int lane,
                                             unsigned (&bq)[NT][KS][2]) {
  const int g = lane >> 2, t = lane & 3;
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
}

// A thread's running (min, row) per query column.
struct Best {
  float v[NCOL];
  int r[NCOL];
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int col = 0; col < NCOL; ++col) {
      v[col] = INFINITY;
      r[col] = 0;
    }
  }
};

// Score this warp's 64 rows of the staged slab (buf_s: its shared address;
// rn: its 128 masked norms; row0: the slab's first row) against the warp's
// 32 queries and fold them into best.
__device__ __forceinline__ void slab_scan(unsigned buf_s, const float* rn,
                                          const unsigned (&bq)[NT][KS][2], float ratio2,
                                          int row0, int wr, int lane, Best& best) {
  const int g = lane >> 2;
  const unsigned lm_off = ldmatrix_offset(lane, PITCH);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int rbase = wr * (SLAB / 2) + mt * 16;
    unsigned a[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(a[kk], buf_s + rbase * PITCH + lm_off + 32 * kk);
    int acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) mma_s8(acc[nt], a[kk], bq[nt][kk][0], bq[nt][kk][1]);
    }
    const float rn0 = rn[rbase + g], rn1 = rn[rbase + g + 8];
    const int row_g = row0 + rbase + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // column 2t + e: row g, then row g + 8
        const int col = 2 * nt + e;
        const float s0 = score(acc[nt][e], rn0, ratio2);
        if (s0 < best.v[col]) {
          best.v[col] = s0;
          best.r[col] = row_g;
        }
        const float s1 = score(acc[nt][2 + e], rn1, ratio2);
        if (s1 < best.v[col]) {
          best.v[col] = s1;
          best.r[col] = row_g + 8;
        }
      }
  }
}

// A window ends: fold the warp's lanes per query column (lexicographic
// (min, row)), write the row half's result into red[p][wr] and reset best.
__device__ __forceinline__ void window_fold(Best& best, float* redv, int* redr, int p, int wr,
                                            int wq, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int col = 0; col < NCOL; ++col) {
    float v = best.v[col];
#pragma unroll
    for (int x = 4; x < 32; x *= 2) {
      const float o = __shfl_xor_sync(0xffffffffu, v, x);
      v = o < v ? o : v;
    }
    int r = best.v[col] == v ? best.r[col] : INT_MAX;
    r = min(r, __shfl_xor_sync(0xffffffffu, r, 4));
    r = min(r, __shfl_xor_sync(0xffffffffu, r, 8));
    r = min(r, __shfl_xor_sync(0xffffffffu, r, 16));
    if (g == 0) {
      const int q = wq * 32 + (col >> 1) * 8 + 2 * t + (col & 1);
      redv[(p * 2 + wr) * QB + q] = v;
      redr[(p * 2 + wr) * QB + q] = r;
    }
  }
  best.reset();
}

// The two row halves of window win0 + wl meet: (min, lowest row) per query.
__device__ __forceinline__ void combine(const float* redv, const int* redr, int wl, int win0,
                                        int qbase, int qp, float* vals, int* args) {
  const int tid = threadIdx.x;
  if (tid < QB) {
    const int p = wl & 1;
    const float v0 = redv[(p * 2) * QB + tid], v1 = redv[(p * 2 + 1) * QB + tid];
    const int r0 = redr[(p * 2) * QB + tid], r1 = redr[(p * 2 + 1) * QB + tid];
    const bool one = v1 < v0 || (v1 == v0 && r1 < r0);
    const size_t o = (size_t)(win0 + wl) * qp + qbase + tid;
    vals[o] = one ? v1 : v0;
    args[o] = one ? r1 : r0;
  }
}

}  // namespace scan
}  // namespace winmin
