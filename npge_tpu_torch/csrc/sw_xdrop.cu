// Banded Smith-Waterman x-drop extension endpoints, one warp per pair.
//
// Replaces npge_tpu/ops/sw.py:_sw_kernel (the Pallas TPU kernel launched at
// npge_tpu/ops/sw.py:200). Same recurrence, band schedule, pruning and tie
// rules; the TPU's superstep layout and 32-aligned character windows are a
// Mosaic constraint and are not carried over.
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
// Layout: lane l of the pair's warp holds band cells 4l .. 4l+3. The parity
// shifts read the neighbour lane's edge cell with __shfl_up_sync /
// __shfl_down_sync; each diagonal's maximum and its first band index come
// from __reduce_max_sync / __reduce_min_sync. Scores are int32 throughout.
//
// Bound: integer operations and the two per-diagonal warp reductions, not
// memory. Each pair reads at most 2L bytes once: the q and t windows are
// staged in shared memory at the start, so the 2L-1 diagonal steps make no
// global loads.
//
// Early exit: once the previous diagonal and the current one are all NEG,
// every later cell is at most NEG + max(match, mismatch, gap, 0), which the
// x-drop test prunes back to NEG whenever that bound is below -xdrop (best
// is never below 0), and no later diagonal can improve best. The loop then
// stops; this is exact, and it is taken only when that bound holds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kW = 128;           // band width
constexpr int kCells = kW / 32;   // band cells per lane
constexpr int kNeg = -(1 << 29);  // pruned / invalid cell
constexpr unsigned kFull = 0xffffffffu;

__global__ void sw_xdrop_kernel(
    const uint8_t* __restrict__ codes2, long long n2,
    const long long* __restrict__ qb, const long long* __restrict__ tb,
    const int* __restrict__ qcap, const int* __restrict__ tcap,
    int* __restrict__ out, int P, int L,
    int match, int mismatch, int gap, int xdrop, int q_n, int t_n,
    bool can_exit) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= P) return;  // the whole warp leaves together

  // stage the pair's windows (mapped codes) in shared memory
  uint8_t* sq = smem + (size_t)warp * 2 * L;
  uint8_t* st = sq + L;
  const int ql = qcap[p];
  const int tl = tcap[p];
  const long long q0 = qb[p];
  const long long t0 = tb[p];
  for (int x = lane; x < ql; x += 32) {
    long long a = q0 + x;
    if (a > n2 - 1) a = n2 - 1;
    const uint8_t c = codes2[a];
    sq[x] = c >= 4 ? (uint8_t)q_n : c;
  }
  for (int y = lane; y < tl; y += 32) {
    long long a = t0 + y;
    if (a > n2 - 1) a = n2 - 1;
    const uint8_t c = codes2[a];
    st[y] = c >= 4 ? (uint8_t)t_n : c;
  }
  __syncwarp();

  // seeds: d = 0 holds only (0, 0) = 0 at band cell W/2; d = 1 holds
  // (1, 0) at cell W/2 when ql >= 1 and (0, 1) at cell W/2 - 1 when tl >= 1
  const int r0 = lane * kCells;
  int prev2[kCells], prev[kCells];
  int pmax = kNeg;
  for (int c = 0; c < kCells; ++c) {
    const int r = r0 + c;
    prev2[c] = (r == kW / 2) ? 0 : kNeg;
    const bool ok1 = (r == kW / 2 && ql >= 1) || (r == kW / 2 - 1 && tl >= 1);
    prev[c] = ok1 ? gap : kNeg;
    pmax = max(pmax, prev[c]);
  }
  pmax = __reduce_max_sync(kFull, pmax);  // max over diagonal d - 1
  int best = max(0, pmax);
  int bi = 0, bj = 0;

  for (int d = 2; d <= 2 * L; ++d) {
    const int ib = (d + 1) / 2 - kW / 2;
    const bool even = (d & 1) == 0;
    // neighbour lanes' edge cells: prev[r0 - 1] and prev[r0 + kCells]
    int below = __shfl_up_sync(kFull, prev[kCells - 1], 1);
    int above = __shfl_down_sync(kFull, prev[0], 1);
    if (lane == 0) below = kNeg;
    if (lane == 31) above = kNeg;
    const int floor_score = best - xdrop;
    int s[kCells];
    int lmax = kNeg;
    for (int c = 0; c < kCells; ++c) {
      const int i = ib + r0 + c;
      const int j = d - i;
      int up, left;
      if (even) {
        up = c == 0 ? below : prev[c - 1];
        left = prev[c];
      } else {
        up = prev[c];
        left = c == kCells - 1 ? above : prev[c + 1];
      }
      int v = kNeg;
      if (i <= ql && j <= tl) {
        if (i >= 1 && j >= 1) {
          const int sub = sq[i - 1] == st[j - 1] ? match : mismatch;
          v = max(v, prev2[c] + sub);
        }
        if (i >= 1 && j >= 0) v = max(v, up + gap);
        if (j >= 1 && i >= 0) v = max(v, left + gap);
      }
      if (v < floor_score) v = kNeg;
      s[c] = v;
      lmax = max(lmax, v);
    }
    const int col_best = __reduce_max_sync(kFull, lmax);
    if (col_best > best) {  // warp-uniform
      int first = kW;
      for (int c = kCells - 1; c >= 0; --c)
        if (s[c] == col_best) first = r0 + c;
      first = __reduce_min_sync(kFull, first);
      bi = ib + first;
      bj = d - bi;
      best = col_best;
    }
    for (int c = 0; c < kCells; ++c) {
      prev2[c] = prev[c];
      prev[c] = s[c];
    }
    if (can_exit && col_best == kNeg && pmax == kNeg) break;
    pmax = col_best;
  }
  if (lane == 0) {
    out[3 * (long long)p + 0] = best;
    out[3 * (long long)p + 1] = bi;
    out[3 * (long long)p + 2] = bj;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int npge_sw_xdrop(
    const void* codes2, long long n2, const void* qb, const void* tb,
    const void* qcap, const void* tcap, void* out, int P, int L, int W,
    int match, int mismatch, int gap, int xdrop, int q_n, int t_n,
    void* stream) {
  if (W != kW || L <= 0 || P <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  int wpb = 4;  // warps (pairs) per block
  size_t smem = (size_t)wpb * 2 * L;
  while (wpb > 1 && smem > 48 * 1024) {
    wpb >>= 1;
    smem = (size_t)wpb * 2 * L;
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
      (const int*)qcap, (const int*)tcap, (int*)out, P, L, match, mismatch,
      gap, xdrop, q_n, t_n, can_exit);
  return (int)cudaGetLastError();
}

extern "C" const char* npge_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
