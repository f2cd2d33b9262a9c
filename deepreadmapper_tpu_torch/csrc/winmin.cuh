// Shared parts of the window-min scans (int8_winmin.cu, pq_winmin.cu).
//
// A block owns QTILE queries, one per thread, each held as 128 int8 values
// in V int4 registers.  It walks WPB consecutive windows of W rows; each
// 128-row slab of a window is staged in shared memory (padded pitch PITCH
// int4 per row) with its masked norms, and every thread then scores the
// slab's rows against its query: s = rn - ratio2 * (q . r), rounded once as
// an explicit FMA, rows in ascending order with a strict '<' so the lowest
// row wins ties.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace winmin {

constexpr int D = 128;                // bytes per row (embedding dim)
constexpr int V = D / 16;             // int4 vectors per row
constexpr int QTILE = 128;            // queries per block, one per thread
constexpr int SLAB = 128;             // rows staged in shared memory at once
constexpr int WPB = 8;                // windows per block
constexpr int PITCH = V + 1;          // padded row pitch (int4)
constexpr float BIG = 3.4e38f;
static_assert(QTILE == SLAB, "the norm pass gives each thread one slab row");

__device__ __forceinline__ int dot16(const int4 a, const int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// This thread's query row into registers.
__device__ __forceinline__ void load_query(const int8_t* q8, int q, int4 (&qv)[V]) {
  const int4* qrow = reinterpret_cast<const int4*>(q8 + (size_t)q * D);
#pragma unroll
  for (int c = 0; c < V; ++c) qv[c] = qrow[c];
}

// Squared norm of staged slab row `row` (exact int), as the masked fp32
// norm of global row row0 + row: rows at or past ntotal never win.
__device__ __forceinline__ float slab_norm(const int4* rows, int row, int row0,
                                           int ntotal) {
  int nrm = 0;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int4 v = rows[row * PITCH + c];
    nrm = dot16(v, v, nrm);
  }
  return (row0 + row < ntotal) ? (float)nrm : BIG;
}

// Score every row of the staged slab against this thread's query and fold
// it into the running (best, best_row).
__device__ __forceinline__ void slab_scan(const int4* rows, const float* rn,
                                          const int4 (&qv)[V], float ratio2,
                                          int row0, float& best, int& best_row) {
  for (int i = 0; i < SLAB; ++i) {
    int acc = 0;
#pragma unroll
    for (int c = 0; c < V; ++c) acc = dot16(rows[i * PITCH + c], qv[c], acc);
    const float s = __fmaf_rn(-ratio2, (float)acc, rn[i]);
    if (s < best) {
      best = s;
      best_row = row0 + i;
    }
  }
}

}  // namespace winmin
