// Banded Smith-Waterman x-drop extension endpoints, one warp per pair,
// designed for Hopper (sm_90a).
//
// Replaces npge_tpu/ops/sw.py:_sw_kernel (the Pallas TPU kernel launched at
// npge_tpu/ops/sw.py:200). Same recurrence, band schedule, pruning and tie
// rules as the plain version ops/sw.py:_sw_torch_core.
//
// Per pair p it aligns q = codes2[qb[p] : qb[p] + qcap[p]] against
// t = codes2[tb[p] : tb[p] + tcap[p]] (caps already clipped to L by the
// caller; reads past the end of codes2 clamp to its last byte). Codes >= 4
// (N) map to q_n in q and t_n in t, so N never matches.
//
//   H(i, j): best score aligning q[0..i) with t[0..j); H(0,0) = 0;
//   moves diag + (match | mismatch), up / left + gap (linear gaps).
//   Anti-diagonal d = i + j holds a band of W = 128 cells r with
//   i = ib(d) + r, ib(d) = (d+1)/2 - W/2. Up and left sources shift by one
//   band cell on even / odd d. A cell below (best over earlier diagonals -
//   xdrop) is pruned to NEG. Output (best, best_i, best_j): the diagonal's
//   maximum at its smallest band index, taken only on strict improvement.
//
// Bound: integer operations, not memory. Each pair reads at most 2L bytes
// once and writes 12; the recurrence needs about 8 int32 operations a cell
// (substitution compare and select, diagonal add, two add-max for up and
// left, x-drop compare and select, running max). On an H100 SXM (132 SMs x
// 64 int32 lanes at the SM clock) that is about 2.1 Tcells/s at 1.98 GHz.
//
// Design, and what it does about that bound:
//  * Lane l of the pair's warp holds band cells 4l .. 4l+3 in registers.
//    The diagonal loop is unrolled by two (one even, one odd diagonal); each
//    half overwrites the diagonal d-2 in place with d (a cell's diagonal
//    source is the same band index two diagonals back), so prev2 / prev / s
//    rotate by renaming, with no copies and no parity branch.
//  * One shuffle of scores per diagonal: the even half needs the lower
//    neighbour's top cell (__shfl_up_sync), the odd half the upper
//    neighbour's bottom cell (__shfl_down_sync).
//  * Characters in registers. A lane keeps its 4 cells' q and t codes packed
//    one byte a cell in two words. From an even diagonal to the next odd one
//    ib grows by one, so every cell's q character moves down one band cell;
//    from odd to even j grows by one, so every t character moves up one. One
//    word shifts by 8 bits (__funnelshift_r / __funnelshift_l) with the edge
//    byte from the neighbour lane by one shuffle; the warp's edge lane
//    (31 for q, 0 for t) reads the one new character from the pair's window
//    in shared memory. __vcmpeq4 gives the 4 cells' equality bytes at once,
//    one LOP3 turns them into 4 substitution-score bytes (the wrapper keeps
//    |match|, |mismatch| <= 127), and a sign-extending byte permute (prmt)
//    hands each cell its score.
//  * DPX for the sources: max(diag + sub, max(up, left) + gap) is
//    __viaddmax_s32(max(up, left), gap, diag + sub): one IMNMX and one DPX
//    add-max.
//  * A NEG border instead of per-cell range tests. The old kernel tested
//    i >= 1 / j >= 1 for each source of each cell. Here every cell outside
//    the matrix holds NEG and in-matrix cells take all three sources: a
//    source outside the matrix (i - 1 < 0 or j - 1 < 0) holds NEG, and NEG
//    plus any score (|score| < 2^20, checked by the wrapper) stays below
//    -xdrop <= best - xdrop, so the x-drop test prunes it back to NEG. A
//    cell's value is therefore the pruned maximum over exactly the sources
//    the old tests admitted, and the characters of a cell with i = 0 or
//    j = 0 are never used. Cells with i < 0 or j < 0 hold NEG the same way
//    (all their sources lie outside the matrix). What remains is the
//    in-matrix mask max(0, d - tl) <= i <= min(ql, d). The whole band lies
//    inside it for a range of diagonals computed once per pair (the common
//    case), where a warp-uniform branch skips the mask; elsewhere its band
//    bounds are computed once per diagonal.
//  * The warp-uniform argmin runs only on diagonals that improve best; it
//    scans a lane's cells from the top so the lowest band index wins before
//    the warp min.
//  * The loop ends at d = ql + tl (no in-matrix cell lies beyond it).
//
// Early exit: once the previous diagonal and the current one are all NEG,
// every later in-matrix cell is at most NEG + max(match, mismatch, gap, 0),
// which the x-drop test prunes back to NEG whenever that bound is below
// -xdrop (best is never below 0), and no later diagonal can improve best.
// The loop then stops; this is exact, and it is taken only when that bound
// holds. The optional output last[p] is the last diagonal the pair
// computed (1 when it computed none), so a caller can count the cells its
// inputs needed: W * (last + 1) per pair.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kW = 128;           // band width
constexpr int kCells = kW / 32;   // band cells per lane
constexpr int kNeg = -(1 << 29);  // pruned / invalid cell
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kQFill = 254;   // q outside [0, qcap) (never matches)
constexpr uint8_t kTFill = 255;   // t outside [0, tcap) (never matches)
// each window is staged with kPad fill bytes before and after it: every
// character index the loop reads lies in [-kPad, L + kPad), so no read is
// clamped (the characters outside [0, cap) are never used, see below)
constexpr int kPad = kW / 2;

// byte c of w as a sign-extended int (prmt with a sign-replicating
// selector)
__device__ __forceinline__ int byte_s32(unsigned w, int c) {
  const unsigned sel = c | ((c | 8) << 4) | ((c | 8) << 8) | ((c | 8) << 12);
  unsigned r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(w), "r"(sel));
  return (int)r;
}

// Diagonal d into s (which holds diagonal d - 2 on entry) from p (diagonal
// d - 1). kEven: up = p[r - 1], left = p[r]; odd: up = p[r], left = p[r + 1].
// `edge` is the neighbour lane's cell that r - 1 or r + 1 reaches (NEG at
// the band's ends); byte c of `subw` is cell c's substitution score. Cells
// outside [lo, hi] (lane-relative band indices) are NEG when kMasked.
// Returns the lane's maximum.
template <bool kEven, bool kMasked>
__device__ __forceinline__ int diagonal(int (&s)[kCells], const int (&p)[kCells],
                                        int edge, unsigned subw, int gap,
                                        int floor_score, int lo, int hi) {
  int lmax = kNeg;
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    int up, left;
    if (kEven) {
      up = c == 0 ? edge : p[c - 1];
      left = p[c];
    } else {
      up = p[c];
      left = c == kCells - 1 ? edge : p[c + 1];
    }
    const int v = __viaddmax_s32(max(up, left), gap, s[c] + byte_s32(subw, c));
    bool keep = v >= floor_score;
    if (kMasked) keep = keep && c >= lo && c <= hi;
    s[c] = keep ? v : kNeg;
    lmax = max(lmax, s[c]);
  }
  return lmax;
}

__global__ void sw_xdrop_kernel(
    const uint8_t* __restrict__ codes2, long long n2,
    const long long* __restrict__ qb, const long long* __restrict__ tb,
    const int* __restrict__ qcap, const int* __restrict__ tcap,
    int* __restrict__ out, int* __restrict__ last, int P, int L,
    int match, int mismatch, int gap, int xdrop, int q_n, int t_n,
    bool can_exit) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= P) return;  // the whole warp leaves together

  // stage the pair's windows (mapped codes, fills outside the caps);
  // sq[x] / st[x] is character x, for x in [-kPad, L + kPad)
  const int span = L + 2 * kPad;
  uint8_t* sq = smem + (size_t)warp * 2 * span + kPad;
  uint8_t* st = sq + span;
  const int ql = qcap[p];
  const int tl = tcap[p];
  const long long q0 = qb[p];
  const long long t0 = tb[p];
#pragma unroll 4
  for (int x = lane - kPad; x < L + kPad; x += 32) {
    uint8_t cq = kQFill, ct = kTFill;
    if (x >= 0 && x < ql) {
      const uint8_t c = codes2[min(q0 + x, n2 - 1)];
      cq = c >= 4 ? (uint8_t)q_n : c;
    }
    if (x >= 0 && x < tl) {
      const uint8_t c = codes2[min(t0 + x, n2 - 1)];
      ct = c >= 4 ? (uint8_t)t_n : c;
    }
    sq[x] = cq;
    st[x] = ct;
  }
  __syncwarp();

  // seeds: d = 0 holds only (0, 0) = 0 at band cell W/2; d = 1 holds
  // (1, 0) at cell W/2 when ql >= 1 and (0, 1) at cell W/2 - 1 when tl >= 1
  const int r0 = lane * kCells;
  int a[kCells], b[kCells];  // diagonals d - 2 and d - 1 at the loop's top
  int pmax = kNeg;
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const int r = r0 + c;
    a[c] = (r == kW / 2) ? 0 : kNeg;
    const bool ok1 = (r == kW / 2 && ql >= 1) || (r == kW / 2 - 1 && tl >= 1);
    b[c] = ok1 ? gap : kNeg;
    pmax = max(pmax, b[c]);
  }
  pmax = __reduce_max_sync(kFull, pmax);  // max over diagonal d - 1
  int best = max(0, pmax);
  int bi = 0, bj = 0;
  // substitution bytes: mismatch, or match where __vcmpeq4 gives 0xff
  const unsigned mis4 = 0x01010101u * (uint8_t)mismatch;
  const unsigned flip4 = 0x01010101u * (uint8_t)(match ^ mismatch);
  // both of two consecutive diagonals all NEG ends the pair when the
  // early exit is exact; their maximum never reaches INT_MAX otherwise
  const int exit_max = can_exit ? kNeg : 0x7fffffff;

  // characters of diagonal 2 (ib = 1 - W/2): cell r needs q[ib + r - 1]
  // and t[2 - ib - r - 1]; byte c of a word is cell r0 + c
  unsigned qw = 0, tw = 0;
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const int r = r0 + c;
    const int ib = 1 - kW / 2;
    qw |= (unsigned)sq[ib + r - 1] << (8 * c);
    tw |= (unsigned)st[2 - ib - r - 1] << (8 * c);
  }

  const int dend = ql + tl;  // no in-matrix cell beyond this diagonal
  int dlast = max(dend, 1);  // unless the pair exits early
  // the band's cells i in [ib, ib + W - 1] all lie inside the matrix,
  // max(0, d - tl) <= i <= min(ql, d), exactly for d in [W - 1, fast_hi]:
  // ib >= 0 iff d >= W - 1; ib + W - 1 <= d iff d >= W - 2;
  // ib >= d - tl iff d <= 2 tl - (W - 1); ib + W - 1 <= ql iff
  // d <= 2 ql - (W - 2) (with ib = (d + 1) / 2 - W / 2, d / 2 = d - ib - W/2)
  const int fast_hi = min(2 * tl - (kW - 1), 2 * ql - (kW - 2));

  // one diagonal: mask bounds, the update, the warp max, the argmin on
  // improvement and the exit test; returns true when the pair is done
  auto step = [&](auto even_tag, int d, int (&s)[kCells],
                  const int (&pv)[kCells]) -> bool {
    constexpr bool kEven = decltype(even_tag)::value;
    const int ib = (d + 1) / 2 - kW / 2;
    const int edge_src = kEven ? pv[kCells - 1] : pv[0];
    int edge = kEven ? __shfl_up_sync(kFull, edge_src, 1)
                     : __shfl_down_sync(kFull, edge_src, 1);
    if (lane == (kEven ? 0 : 31)) edge = kNeg;
    const unsigned subw = mis4 ^ (__vcmpeq4(qw, tw) & flip4);
    const int floor_score = best - xdrop;
    int lmax;
    if (d >= kW - 1 && d <= fast_hi) {  // warp-uniform: whole band inside
      lmax = diagonal<kEven, false>(s, pv, edge, subw, gap, floor_score, 0, 0);
    } else {
      // in-matrix band range [rlo, rhi] of this diagonal
      const int rlo = max(0, d - tl) - ib;
      const int rhi = min(ql, d) - ib;
      lmax = diagonal<kEven, true>(s, pv, edge, subw, gap, floor_score,
                                   rlo - r0, rhi - r0);
    }
    const int col_best = __reduce_max_sync(kFull, lmax);
    if (col_best > best) {  // warp-uniform
      int first = kW;
#pragma unroll
      for (int c = kCells - 1; c >= 0; --c)
        if (s[c] == col_best) first = r0 + c;
      first = __reduce_min_sync(kFull, first);
      bi = ib + first;
      bj = d - bi;
      best = col_best;
    }
    const bool done = max(col_best, pmax) == exit_max;
    pmax = col_best;
    if (done) dlast = d;
    return done;
  };

  for (int d = 2; d <= dend; d += 2) {
    // even d: a holds d - 2, b holds d - 1; a becomes d
    if (step(std::true_type{}, d, a, b) || d + 1 > dend) break;
    // even -> odd: ib grows by one, q characters move down one cell
    {
      unsigned nb = __shfl_down_sync(kFull, qw, 1);
      if (lane == 31) nb = sq[(d + 2) / 2 - kW / 2 + kW - 2];
      qw = __funnelshift_r(qw, nb, 8);
    }
    // odd d + 1: b holds d - 1, a holds d; b becomes d + 1
    if (step(std::false_type{}, d + 1, b, a)) break;
    // odd -> even: j grows by one, t characters move up one cell
    {
      unsigned nb = __shfl_up_sync(kFull, tw, 1);
      const int d2 = d + 2;
      if (lane == 0) nb = (unsigned)st[d2 - ((d2 + 1) / 2 - kW / 2) - 1] << 24;
      tw = __funnelshift_l(nb, tw, 8);
    }
  }
  if (lane == 0) {
    out[3 * (long long)p + 0] = best;
    out[3 * (long long)p + 1] = bi;
    out[3 * (long long)p + 2] = bj;
    if (last != nullptr) last[p] = dlast;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). `last` may
// be null; otherwise it receives each pair's last computed diagonal.
extern "C" int npge_sw_xdrop(
    const void* codes2, long long n2, const void* qb, const void* tb,
    const void* qcap, const void* tcap, void* out, void* last, int P, int L,
    int W, int match, int mismatch, int gap, int xdrop, int q_n, int t_n,
    void* stream) {
  if (W != kW || L <= 0 || P <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  if (max(abs(match), abs(mismatch)) > 127) return (int)cudaErrorInvalidValue;
  int wpb = 4;  // warps (pairs) per block
  size_t smem = (size_t)wpb * 2 * (L + 2 * kPad);
  while (wpb > 1 && smem > 48 * 1024) {
    wpb >>= 1;
    smem = (size_t)wpb * 2 * (L + 2 * kPad);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_xdrop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int top = max(max(match, mismatch), max(gap, 0));
  const bool can_exit = (long long)kNeg + top + xdrop < 0;
  const dim3 grid((unsigned)((P + wpb - 1) / wpb));
  sw_xdrop_kernel<<<grid, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes2, n2, (const long long*)qb, (const long long*)tb,
      (const int*)qcap, (const int*)tcap, (int*)out, (int*)last, P, L, match,
      mismatch, gap, xdrop, q_n, t_n, can_exit);
  return (int)cudaGetLastError();
}

extern "C" const char* npge_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
