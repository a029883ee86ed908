// Linear sum assignment on the card for Hopper (sm_90a), plain C interface.
//
// Kernel L1, mpa_lap: the exact assignment of each [n, n] f32 cost matrix
// of a batch, col4row [M, n] int32 (the column of each row).  It is the
// device counterpart of the JAX package's XLA solve (multi_part_assembly_
// tpu/ops/matching.py:25-95, `_solve_lap_single` under vmap), which keeps
// semantic assembly's Hungarian matching on the accelerator.  That solve is
// XLA while-loops, not a Pallas kernel; eager PyTorch runs it as thousands
// of small launches a solve, so the card gets this kernel instead.
//
// The algorithm is JAX's shortest augmenting path with dual variables u
// (rows) and v (columns): for each row cur, a Dijkstra search over the
// columns from cur until an unassigned column (the sink), the dual
// updates, then the augmenting walk back along pathback.  The arithmetic
// is JAX's, in its order (r = ((min_val + cost[i][j]) - u[i]) - v[j], the
// updates of matching.py:62-66; the build has -fmad=false, so nothing
// fuses), and the argmin takes the first minimum, as jnp.argmin does: the
// kernel and the plain version (ops/matching.py solve_lap_plain) give the
// same assignment bit for bit on the same cost.
//
// Layout: one warp a problem, n <= 32.  Lane j owns column j (v, shortest,
// pathback, the visited flag SC, row4col) and row j (u, col4row, the
// visited flag SR), all in registers; the argmin over columns is a
// butterfly of shuffles on (value, index), the smaller index winning a tie,
// so every lane ends with the same answer; the augmenting walk is uniform
// control flow on broadcast indices.  Each Dijkstra step reads one row of
// the cost, n consecutive floats.
//
// What bounds it on the card: neither bytes nor operations.  A batch reads
// M * n^2 * 4 bytes (160 problems at n = 20: 256 KB, under 0.1 us at the
// HBM rate) and does O(n^3) simple operations a problem; what remains is
// the launch itself and the chain of dependent steps of one warp (up to
// n (n + 1) / 2 Dijkstra steps of a shuffle reduction each), so it is
// latency-bound at these sizes, and one launch serves every problem.
//
// A cost with NaN or infinite entries has no defined assignment: the loops
// are capped at n steps, so such input gives an unspecified answer, never
// a hang.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;  // problems a block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
lap_kernel(const float* __restrict__ cost, int* __restrict__ out, int M,
           int n) {
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;  // the whole warp
  const float* C = cost + m * n * n;
  const bool is_col = lane < n;
  const float kInf = CUDART_INF_F;
  float v = 0.f, u = 0.f;       // column lane's v, row lane's u
  int row4col = -1, col4row = -1;
  for (int cur = 0; cur < n; ++cur) {
    // --- Dijkstra from row cur until an unassigned column ---
    float shortest = kInf, min_val = 0.f;
    int pathback = -1, i = cur, sink = 0;
    bool SC = false, SR = false;
    for (int step = 0; step < n; ++step) {
      if (lane == i) SR = true;
      const float ui = __shfl_sync(kFull, u, i);
      if (is_col) {
        const float r = ((min_val + __ldg(C + i * n + lane)) - ui) - v;
        if (r < shortest && !SC) {
          shortest = r;
          pathback = i;
        }
      }
      float bv = (SC || !is_col) ? kInf : shortest;
      int bj = lane;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oj = __shfl_xor_sync(kFull, bj, off);
        if (ov < bv || (ov == bv && oj < bj)) {
          bv = ov;
          bj = oj;
        }
      }
      if (lane == bj) SC = true;
      const int nxt = __shfl_sync(kFull, row4col, bj);
      min_val = bv;
      sink = bj;
      if (nxt < 0) break;
      i = nxt;
    }
    // --- dual updates (matching.py:62-66) ---
    if (lane == cur) u = u + min_val;
    const float sh = __shfl_sync(kFull, shortest, col4row < 0 ? 0 : col4row);
    if (SR && lane != cur) u = (u + min_val) - sh;
    if (SC) v = v - (min_val - shortest);
    // --- augment along the alternating path ---
    int j = sink;
    for (int step = 0; step < n; ++step) {
      const int ia = __shfl_sync(kFull, pathback, j);
      if (ia < 0) break;  // only for non-finite cost
      if (lane == j) row4col = ia;
      const int nxt = __shfl_sync(kFull, col4row, ia);
      if (lane == ia) col4row = j;
      if (ia == cur) break;
      j = nxt < 0 ? 0 : nxt;
    }
  }
  if (is_col) out[m * n + lane] = col4row;
}

}  // namespace

extern "C" {

// cost [M, n, n] f32 -> col4row [M, n] int32, n <= 32.  Returns a
// cudaError_t.
int mpa_lap(const float* cost, int* col4row, int M, int n, void* stream) {
  if (M == 0 || n == 0) return 0;
  if (n > 32 || M < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (M + kWarps - 1) / kWarps;
  lap_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(cost, col4row,
                                                               M, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
