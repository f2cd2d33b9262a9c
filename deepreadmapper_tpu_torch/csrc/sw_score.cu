// Smith-Waterman local score of each (a, b) byte pair: +1 match, -1
// mismatch, linear gap -1, the score is the max DP cell.
//
// Replaces deepreadmapper_tpu/ops/sw_pallas.py::_sw_kernel (driven by
// _sw_pallas_call, sw_scores_pallas / sw_scores_auto), the SW rerank of
// `pipeline --rerank sw`: a = candidate genome windows, b = '<'-wrapped reads.
// Like sw_scores_auto it takes pairs of any width.
//
// What bounds it on an H100: instruction issue.  The DP has no tensor-core
// form and reads only the pairs' bytes.  A score is at most min(la, lb), no
// DP value the kernel forms exceeds it, and the relu floor keeps cells >= 0,
// so while the rows (the narrower side, ops/sw.py) are at most 32,767 bytes
// every value fits in 16 bits and Hopper's DPX instructions carry two pairs
// in each register, one in each 16-bit half; a pair of cells costs 5.5
// instructions:
//   z    = A ^ B[k]                  A = ~2a, B = 2b: -1 on a match, <= -3 else
//   s1   = viaddmax_relu(z, 3, z)    2 on a match, 0 else (s + 1)
//   x    = viaddmax(D, s1, U[k])     max(Hd + s, Hu - 1); the row above is kept as H - 1
//   H    = viaddmax_relu(H, -1, x)   max(Hl - 1, x, 0), the only link along the row
//   U[k] = viaddmax(H, -1, z)        H - 1 for the row below (z <= -1 <= H - 1)
//   best = vimax3(best, x, x')       one for two cells (the max H is max(x, 0))
// Each takes at most one constant, as an immediate: a second one (0 or -1)
// would cost a register move nearly every time (ptxas rematerialises it).
// Past 32,767-byte rows the same steps run on one pair a register in the
// s32 forms of those instructions, 5.5 a cell.  chip_smoke.py counts these
// (SW_OPS_PER_CELL) against the DPX rates it measures with sw_dpx_rate below.
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
//   kept for lane 0 of the next pass.
// - Seven or eight scalar int32 instructions a cell are 2.75 here (above).
// - A block's 58 KB of shared memory (the a rows and an int16 edge column a
//   thread) allowed 3 blocks an SM.  Now shared memory holds only the packed
//   A word of each group and row (NG x lr x 4 bytes; 19 KB at G = 4, lr 150),
//   read by all lanes of a group at once (a broadcast).
// Three tiers, chosen by ops/sw.py::sw_layout from the widths alone, run
// this one kernel body (the template's TIER):
// - SHARED: the A words, and between passes two edge words a row, in shared
//   memory; the rows up to 4,842 bytes (with passes; the main path's 150).
// - GLOBAL: rows of 4,843-32,767 bytes.  The A words and one edge word a row
//   live in a global scratch the wrapper allocates (NG x (lr | 1 + lr)
//   words a block), filled by the block's own prologue.  Lane g reads row
//   t - g at step t, so a group's lanes read consecutive words (coalesced,
//   L1-resident); lane 0 of a pass reads edge row i before lane G - 1 of
//   that pass overwrites it, so one edge buffer does.
// - INT32: rows past 32,767 bytes, one pair a group in 32-bit lanes, the
//   GLOBAL tier's layout: no score wraps.
// Between passes __syncwarp orders the edge writes before the next pass's
// reads, in shared or in global memory.
// Bytes past a pair's la read as 254 and past lb as 255 (the sentinels of
// ops/sw.py): they never match, so cells there only decay and the best
// stays the true-length DP's.  Each group runs to the longer of its la; a
// missing second pair (odd P, and the INT32 tier's) has length 0.
// Two sources of the pairs' bytes (the template's BYID), in every tier:
// - byte matrices a [P, lr] and b [P, lc] with their lengths (sw_score);
// - windows by id (sw_score_by_id, the SW rerank's): pair p is the window
//   ids[p] of a device copy of the genome against the query row p / C.  A
//   window is read where it is scored: id >> 1 is its position, and an odd
//   id reads genome[pos + ref_len - 1 - i] through the complement table,
//   io/fasta.py's COMP; a window that does not lie inside the genome is
//   ref_len zero bytes, as io/fasta.py::fetch_windows_by_id returns it.
//   The windows are the rows when ref_len is at most the query rows' width,
//   else the columns, as ops/sw.py::sw_scores would lay them out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned M1 = 0xffffffffu;     // (-1, -1), and -1
constexpr unsigned PAD_A = 254u;
constexpr unsigned PAD_B = 255u;

// where a launch keeps its rows and pass edges, and what a lane carries
// (ops/sw.py's tier names, in this order)
enum Tier : int { SHARED = 0, GLOBAL = 1, INT32 = 2 };

__device__ __forceinline__ int clamp_len(int n, int width) {
  return min(max(n, 0), width);
}

// io/fasta.py's COMP: A<->T, C<->G, N->N, every other byte 0
struct CompTable { uint8_t v[256]; };
constexpr CompTable make_comp() {
  CompTable t{};
  t.v['A'] = 'T'; t.v['T'] = 'A'; t.v['C'] = 'G'; t.v['G'] = 'C'; t.v['N'] = 'N';
  return t;
}
__constant__ CompTable kComp = make_comp();

// The by-id source: pair p of a launch is the window ids[p] of the genome
// against query row (first + p) / C, ids 2 pos | strand
struct ById {
  const uint8_t* genome;
  const long long* ids;
  long long glen;
  const uint8_t* q;    // query rows, as wide as the side they are on
  const int* qlen;
  int C;               // pairs a query
  int first;           // the launch's first pair in its call
  int windows_rows;    // 1: the windows are the rows (a), 0: the columns (b)
};

// One pair's bytes on one side: base[i] below len, or (rev) the complement
// of base[-i]; no base: len zero bytes
struct Row {
  const uint8_t* base;
  int len;
  bool rev;
};

__device__ __forceinline__ unsigned row_byte(const Row& r, int i) {
  if (r.base == nullptr) return 0u;
  return r.rev ? (unsigned)kComp.v[r.base[-i]] : (unsigned)r.base[i];
}

__device__ __forceinline__ Row window_row(const ById& s, int p, int width) {
  const long long id = s.ids[p];
  const long long pos = id >> 1;
  if (pos < 0 || pos + width > s.glen) return {nullptr, width, false};
  return (id & 1) ? Row{s.genome + pos + width - 1, width, true}
                  : Row{s.genome + pos, width, false};
}

__device__ __forceinline__ Row query_row(const ById& s, int p, int width) {
  const int r = (s.first + p) / s.C;
  return {s.q + (size_t)r * width, clamp_len(s.qlen[r], width), false};
}

// pair p's row (a, lr wide) and column (b, lc wide) sides, by id
__device__ __forceinline__ Row a_row(const ById& s, int p, int lr) {
  return s.windows_rows ? window_row(s, p, lr) : query_row(s, p, lr);
}

__device__ __forceinline__ Row b_row(const ById& s, int p, int lc) {
  return s.windows_rows ? query_row(s, p, lc) : window_row(s, p, lc);
}

// The DPX steps on two 16-bit halves, or (W32) on one 32-bit value
template <bool W32>
__device__ __forceinline__ unsigned addmax(unsigned a, unsigned b, unsigned c) {
  if constexpr (W32) return (unsigned)__viaddmax_s32((int)a, (int)b, (int)c);
  else return __viaddmax_s16x2(a, b, c);
}

template <bool W32>
__device__ __forceinline__ unsigned addmax_relu(unsigned a, unsigned b, unsigned c) {
  if constexpr (W32) return (unsigned)__viaddmax_s32_relu((int)a, (int)b, (int)c);
  else return __viaddmax_s16x2_relu(a, b, c);
}

template <bool W32>
__device__ __forceinline__ unsigned max3_relu(unsigned a, unsigned b, unsigned c) {
  if constexpr (W32) return (unsigned)__vimax3_s32_relu((int)a, (int)b, (int)c);
  else return __vimax3_s16x2_relu(a, b, c);
}

template <bool W32>
__device__ __forceinline__ unsigned max_relu(unsigned a, unsigned b) {
  if constexpr (W32) return (unsigned)__vimax_s32_relu((int)a, (int)b);
  else return __vimax_s16x2_relu(a, b);
}

template <int S, int TIER, bool BYID>
__global__ void __launch_bounds__(THREADS)
sw_score_kernel(const uint8_t* __restrict__ a, const int* __restrict__ alen,
                const uint8_t* __restrict__ b, const int* __restrict__ blen,
                const ById byid, int* __restrict__ out, unsigned* scratch, int np,
                int lr, int lc, int G, int passes) {
  constexpr bool W32 = TIER == INT32;
  constexpr int PG = W32 ? 1 : 2;      // pairs a group
  constexpr unsigned THREE = W32 ? 3u : 0x00030003u;
  extern __shared__ unsigned smem[];
  const int ng = THREADS / G;          // groups of the block
  const int pitch = lr | 1;            // odd: the groups' words of a row fall in distinct banks
  // [ng][pitch] A words, then the right edges between passes: [2][ng][lr]
  // in shared memory, [ng][lr] in the block's slice of the global scratch
  unsigned* a_sh = TIER == SHARED ? smem : scratch + (size_t)blockIdx.x * ng * (pitch + lr);
  unsigned* edge = a_sh + ng * pitch;

  const int tid = threadIdx.x;
  const int grp = tid / G, g = tid % G;
  const int p0 = blockIdx.x * PG * ng;  // the block's pairs are contiguous
  const int rows_here = min(PG * ng, np - p0);

  // A word of a row: ~2a of pair 2m in the low half, of pair 2m + 1 in the
  // high half; in 32-bit lanes ~2a of pair m
  const uint8_t* ablk = a + (size_t)p0 * lr;
  for (int idx = tid; idx < PG * ng * lr; idx += THREADS) {
    const int t = idx / lr, i = idx - t * lr;
    unsigned byte = PAD_A;
    if constexpr (BYID) {
      if (t < rows_here) {
        const Row r = a_row(byid, p0 + t, lr);
        if (i < r.len) byte = row_byte(r, i);
      }
    } else if (t < rows_here && i < clamp_len(alen[p0 + t], lr)) {
      byte = ablk[idx];
    }
    if constexpr (W32)
      a_sh[t * pitch + i] = ~(byte << 1);
    else
      reinterpret_cast<uint16_t*>(a_sh)[((t >> 1) * pitch + i) * 2 + (t & 1)] =
          (uint16_t)~(byte << 1);
  }
  __syncthreads();

  const int plo = p0 + PG * grp, phi = W32 ? np : plo + 1;  // no second pair in 32-bit lanes
  int la, lb_lo, lb_hi;
  const uint8_t *b_lo = nullptr, *b_hi = nullptr;
  Row rb_lo{nullptr, 0, false}, rb_hi{nullptr, 0, false};
  if constexpr (BYID) {
    la = max(plo < np ? a_row(byid, plo, lr).len : 0, phi < np ? a_row(byid, phi, lr).len : 0);
    if (plo < np) rb_lo = b_row(byid, plo, lc);
    if (phi < np) rb_hi = b_row(byid, phi, lc);
    lb_lo = rb_lo.len;
    lb_hi = rb_hi.len;
  } else {
    la = max(plo < np ? clamp_len(alen[plo], lr) : 0, phi < np ? clamp_len(alen[phi], lr) : 0);
    lb_lo = plo < np ? clamp_len(blen[plo], lc) : 0;
    lb_hi = phi < np ? clamp_len(blen[phi], lc) : 0;
    b_lo = b + (size_t)min(plo, np - 1) * lc;
    b_hi = b + (size_t)min(phi, np - 1) * lc;
  }
  const int steps = (int)__reduce_max_sync(FULL, (unsigned)la) + G - 1;
  const unsigned* arow = a_sh + grp * pitch - g;  // arow[t]: the row lane g takes at step t

  unsigned best = 0;
  for (int q = 0; q < passes; ++q) {
    const int c0 = (q * G + g) * S;
    unsigned bw[S], up[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int c = c0 + k;
      unsigned lo = PAD_B, hi = PAD_B;
      if constexpr (BYID) {
        if (c < lb_lo) lo = row_byte(rb_lo, c);
        if (!W32 && c < lb_hi) hi = row_byte(rb_hi, c);
      } else {
        if (c < lb_lo) lo = b_lo[c];
        if (!W32 && c < lb_hi) hi = b_hi[c];
      }
      bw[k] = W32 ? lo << 1 : (lo << 1) | (hi << 17);
      up[k] = M1;  // the row above row 0: H = 0
    }
    // pass q - 1's edges, and this pass's: one buffer outside shared memory
    const int bin = TIER == SHARED ? (q + 1) & 1 : 0, bout = TIER == SHARED ? q & 1 : 0;
    const unsigned* ein = edge + (size_t)(bin * ng + grp) * lr;
    unsigned* eout = edge + (size_t)(bout * ng + grp) * lr;
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
          const unsigned s1 = addmax_relu<W32>(z, THREE, z);
          const unsigned x = addmax<W32>(diag, s1, up[k]);
          if (k & 1) best = max3_relu<W32>(best, x_even, x);
          else x_even = x;
          diag = up[k];
          h = addmax_relu<W32>(h, M1, x);
          up[k] = addmax<W32>(h, M1, z);
        }
        if (S & 1) best = max_relu<W32>(best, x_even);
        right = h;
        if (g == G - 1 && q + 1 < passes) eout[i] = h;
        dm1 = addmax<W32>(left, M1, A);  // left - 1 (A <= -1)
      }
    }
    __syncwarp();  // eout complete before the next pass reads it
  }
  for (int o = G >> 1; o > 0; o >>= 1)
    best = max_relu<W32>(best, __shfl_xor_sync(FULL, best, o, G));
  if (g == 0) {
    if constexpr (W32) {
      if (plo < np) out[plo] = (int)best;
    } else {
      if (plo < np) out[plo] = (int)(best & 0xffffu);
      if (phi < np) out[phi] = (int)(best >> 16);
    }
  }
}

template <int S, int TIER, bool BYID>
int launch(const void* a, const void* alen, const void* b, const void* blen,
           const ById& byid, void* out, void* scratch, int np, int lr, int lc, int G,
           int passes, cudaStream_t stream) {
  const int ng = THREADS / G;
  size_t smem = 0;
  if constexpr (TIER == SHARED) {
    smem = ((size_t)ng * (lr | 1) + (passes > 1 ? (size_t)2 * ng * lr : 0)) *
           sizeof(unsigned);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sw_score_kernel<S, TIER, BYID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  } else if (scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pg = TIER == INT32 ? 1 : 2;
  const int blocks = ((np + pg - 1) / pg + ng - 1) / ng;
  sw_score_kernel<S, TIER, BYID><<<blocks, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const int*>(alen),
      static_cast<const uint8_t*>(b), static_cast<const int*>(blen), byid,
      static_cast<int*>(out), static_cast<unsigned*>(scratch), np, lr, lc, G, passes);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of the layout ops/sw.py::sw_layout chose
template <bool BYID>
int dispatch(const void* a, const void* alen, const void* b, const void* blen,
             const ById& byid, void* out, void* scratch, int np, int lr, int lc,
             int groups, int strip, int passes, int tier, void* stream) {
  if (groups < 1 || groups > 32 || (groups & (groups - 1)) || passes < 1 ||
      (long long)groups * strip * passes < lc)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SW_CASE(S, T)                                                          \
  case S:                                                                      \
    return launch<S, T, BYID>(a, alen, b, blen, byid, out, scratch, np, lr, lc, \
                              groups, passes, st);
  switch (tier) {
    case SHARED:
      switch (strip) {
        SW_CASE(1, SHARED) SW_CASE(2, SHARED) SW_CASE(3, SHARED) SW_CASE(4, SHARED)
        SW_CASE(5, SHARED) SW_CASE(6, SHARED) SW_CASE(8, SHARED) SW_CASE(10, SHARED)
        SW_CASE(12, SHARED) SW_CASE(16, SHARED) SW_CASE(20, SHARED)
        SW_CASE(24, SHARED) SW_CASE(32, SHARED) SW_CASE(40, SHARED)
      }
      break;
    case GLOBAL:
      switch (strip) { SW_CASE(32, GLOBAL) SW_CASE(40, GLOBAL) }
      break;
    case INT32:
      switch (strip) { SW_CASE(32, INT32) SW_CASE(40, INT32) }
      break;
  }
#undef SW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// A loop of independent DPX add-max instructions on every scheduler, on
// 16-bit halves or (W32) on 32-bit values: the rates the bounds of sw_score
// divide by (chip_smoke.py).
template <bool W32>
__global__ void __launch_bounds__(256) dpx_rate_kernel(unsigned* out, int iters) {
  unsigned v[8];
  const unsigned c = (unsigned)iters * 0x00050003u;
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = (threadIdx.x + 37u * j) * 0x00010001u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = addmax_relu<W32>(v[j], M1, c);
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
// holds, one of dispatch's instantiations), passes and tier (0 SHARED, 1
// GLOBAL, 2 INT32) come from ops/sw.py::sw_layout; G x S x passes >= lc.
// The GLOBAL and INT32 tiers take G = 32 and S 32 or 40 (their lc is past
// 32 x 40 columns), and scratch: ceil(ceil(np / pairs a group) / (128 / G))
// x (128 / G) x ((lr | 1) + lr) uint32 words (ops/sw.py::sw_scratch_bytes).
extern "C" int sw_score(const void* a, const void* alen, const void* b,
                        const void* blen, void* out, void* scratch, int np, int lr,
                        int lc, int groups, int strip, int passes, int tier,
                        void* stream) {
  return dispatch<false>(a, alen, b, blen, ById{}, out, scratch, np, lr, lc, groups,
                         strip, passes, tier, stream);
}

// The same scores with the pairs' bytes read by id: genome [glen] uint8,
// ids [np] int64 (the launch's pairs first .. first + np - 1 of its call),
// q [np / C rows of the call, width] uint8 with qlen int32 -> out [np].
// windows_rows 1: the windows (ref_len) are the rows, lr = ref_len and the
// query rows lc wide; 0: the windows are the columns, lc = ref_len and the
// query rows lr wide.  The layout as for sw_score.
extern "C" int sw_score_by_id(const void* genome, long long glen, const void* ids,
                              const void* q, const void* qlen, int pairs_a_query,
                              int first, int windows_rows, void* out, void* scratch,
                              int np, int lr, int lc, int groups, int strip, int passes,
                              int tier, void* stream) {
  if (pairs_a_query < 1 || first < 0) return static_cast<int>(cudaErrorInvalidValue);
  const ById byid{static_cast<const uint8_t*>(genome), static_cast<const long long*>(ids),
                  glen, static_cast<const uint8_t*>(q), static_cast<const int*>(qlen),
                  pairs_a_query, first, windows_rows};
  return dispatch<true>(nullptr, nullptr, nullptr, nullptr, byid, out, scratch, np, lr,
                        lc, groups, strip, passes, tier, stream);
}

// The complement table the by-id source reads, 256 bytes into out (host
// memory): the tests hold it to io/fasta.py's COMP.
extern "C" int sw_comp_table(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, kComp, sizeof(kComp)));
}

// out [blocks x 256] uint32; each thread runs iters x 32 DPX add-max
// instructions: __viaddmax_s16x2_relu, or __viaddmax_s32_relu when s32 is 1.
extern "C" int sw_dpx_rate(void* out, int blocks, int iters, int s32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s32)
    dpx_rate_kernel<true><<<blocks, 256, 0, st>>>(static_cast<unsigned*>(out), iters);
  else
    dpx_rate_kernel<false><<<blocks, 256, 0, st>>>(static_cast<unsigned*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
