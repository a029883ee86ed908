// Linear sum assignment on the card for Hopper (sm_90a), plain C interface.
//
// Two kernels of semantic assembly's Hungarian matching (ops/matching.py
// `match_parts`): L2 builds each shape's block-masked P x P cost, L1 solves
// the assignment on it.
//
// Kernel L2, mpa_lap_cost (lap_cost_kernel): the block-masked LAP cost
// [B, P, P] f32 of the subsample moved by the predicted poses, a
// [B, P, n, 3], against the subsample moved by the true poses, b, under the
// group labels match_ids [B, P] int32.  Inside a group (equal nonzero ids)
// the entry [s, i, j] is the mean over a[s, i]'s points of the nearest
// squared distance in b[s, j], plus the same with a and b swapped; 1e9
// elsewhere; 0 on the diagonal of an ungrouped row (padded parts
// included).  It is the plain path's `lap_cost(_pair_chamfer_cost(a, b),
// match_ids)`.  It replaces no Pallas kernel: the JAX package's
// `_pair_chamfer_cost` (multi_part_assembly_tpu/ops/matching.py:111-146)
// is XLA, which builds the [B, P, P, n, n] distances for every part pair
// and then masks all but the in-group ones away; eager PyTorch did the
// same in several passes over 512 MB at B = 32, P = 20, n = 100.
//
// What bounds it: FP32 issue on the in-group pairs, and at the main path's
// sizes latency.  The chair traffic holds about 14 in-group part pairs of
// 400 a shape: 4.4e6 point pairs a sample, about 1.3 us at 10 operations
// a pair; the bytes (a, b and the cost, about 1 MB) are less.  The design
// keeps the [B, P, P, n, n] intermediate out of device memory and touches
// only the in-group pairs, which it reads from match_ids: one block a
// (shape, row part), so each block writes its whole row and nothing needs a
// memset.  An ungrouped row writes its constants and leaves.  A grouped row
// runs 2H threads, H = n rounded up to a warp: thread t < H holds a[s, i]'s
// point t in registers (and in shared memory), thread H + q holds point q
// of the current in-group part b[s, j] (and stages it in shared memory),
// and for each j in turn (in column order) each thread takes the nearest
// squared distance of its point in the other cloud, reading that cloud from
// shared memory (one broadcast read a point).  While they do, the second
// half loads the next in-group part's points into registers.  A distance
// is (ax - bx)^2 + (ay - by)^2 + (az - bz)^2 with each operation rounded on
// its own (-fmad=false), as B1 computes it: no tensor cores, since the
// expanded x^2 + y^2 - 2 x.y cancels where the points are close, which the
// benchmark's f64 reference does not.  Each half's minima are summed in a
// fixed tree (a warp's butterfly, then the warps in order), with no
// atomics, so two launches give the same bits; each sum is divided by n
// and the two quotients added.  A point with a non-finite coordinate makes
// its pair's cost NaN, as the plain path's min does.  n <= 256 (two halves
// of at most 256 threads); P is whatever the batch has.
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

// --- L2: the block-masked LAP cost ---

constexpr int kMaxCostN = 256;               // points a part
constexpr int kCostWarps = 2 * kMaxCostN / 32;
constexpr float kBig = 1e9f;                 // ops/matching.py _BIG

__device__ __forceinline__ float sq_dist(float px, float py, float pz,
                                         float4 q) {
  const float dx = px - q.x, dy = py - q.y, dz = pz - q.z;
  return (dx * dx + dy * dy) + dz * dz;
}

// The first part at or after `from` in group `g` of a shape, or P.
__device__ __forceinline__ int next_in_group(const int* __restrict__ mid,
                                             int P, int g, int from) {
  while (from < P && __ldg(mid + from) != g) ++from;
  return from;
}

__global__ void __launch_bounds__(2 * kMaxCostN)
lap_cost_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const int* __restrict__ ids, float* __restrict__ out, int P,
                int n) {
  __shared__ float4 sa[kMaxCostN];
  __shared__ float4 sb[kMaxCostN];
  __shared__ float wsum[kCostWarps];
  const long long row = blockIdx.x;  // shape s, part i
  const long long shape = row / P;
  const int i = (int)(row - shape * P);
  const int* mid = ids + shape * P;
  float* o = out + row * P;
  const int g = __ldg(mid + i);
  if (g <= 0) {  // a part of its own, or padding: keeps its own part
    for (int j = threadIdx.x; j < P; j += blockDim.x) o[j] = j == i ? 0.f
                                                                    : kBig;
    return;
  }
  for (int j = threadIdx.x; j < P; j += blockDim.x)
    if (__ldg(mid + j) != g) o[j] = kBig;
  const int H = blockDim.x >> 1;
  const bool second = threadIdx.x >= H;  // a point of b[s, j]
  const int t = second ? threadIdx.x - H : threadIdx.x;
  const bool live = t < n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int j = next_in_group(mid, P, g, 0);  // i's group holds i: j <= i
  const float* src = second ? b + ((shape * P + j) * n + t) * 3
                            : a + ((shape * P + i) * n + t) * 3;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (live) {
    px = __ldg(src);
    py = __ldg(src + 1);
    pz = __ldg(src + 2);
    (second ? sb : sa)[t] = make_float4(px, py, pz, 0.f);
  }
  __syncthreads();
  const float4* other = second ? sa : sb;
  for (;;) {
    const int next = next_in_group(mid, P, g, j + 1);
    float nx = 0.f, ny = 0.f, nz = 0.f;
    if (second && live && next < P) {  // the next part, while this one runs
      const float* q = b + ((shape * P + next) * n + t) * 3;
      nx = __ldg(q);
      ny = __ldg(q + 1);
      nz = __ldg(q + 2);
    }
    float v = 0.f;
    if (live) {
      float m0 = CUDART_INF_F, m1 = CUDART_INF_F;
      int k = 0;
      for (; k + 1 < n; k += 2) {
        m0 = fminf(m0, sq_dist(px, py, pz, other[k]));
        m1 = fminf(m1, sq_dist(px, py, pz, other[k + 1]));
      }
      if (k < n) m0 = fminf(m0, sq_dist(px, py, pz, other[k]));
      // fminf passes over NaN: a non-finite coordinate of this point
      // makes the sum NaN, as the plain path's min does
      v = fminf(m0, m1) + 0.f * ((px + py) + pz);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) wsum[warp] = v;
    __syncthreads();  // the sums are in; every read of sb is done
    if (threadIdx.x == 0) {
      const int half = H >> 5;
      float s1 = 0.f, s2 = 0.f;
      for (int w = 0; w < half; ++w) s1 += wsum[w];
      for (int w = half; w < 2 * half; ++w) s2 += wsum[w];
      o[j] = s1 / (float)n + s2 / (float)n;
    }
    if (next >= P) break;
    if (second && live) {
      px = nx;
      py = ny;
      pz = nz;
      sb[t] = make_float4(px, py, pz, 0.f);
    }
    __syncthreads();  // the next part staged; wsum read
    j = next;
  }
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

// a [B, P, n, 3] f32, b [B, P, n, 3] f32, match_ids [B, P] int32 -> cost
// [B, P, P] f32, 1 <= n <= 256.  Returns a cudaError_t.
int mpa_lap_cost(const float* a, const float* b, const int* match_ids,
                 float* cost, int B, int P, int n, void* stream) {
  if (B == 0 || P == 0) return 0;
  const long long rows = (long long)B * P;
  if (B < 0 || P < 0 || n < 1 || n > kMaxCostN || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int threads = 2 * ((n + 31) / 32 * 32);
  lap_cost_kernel<<<(unsigned)rows, threads, 0, (cudaStream_t)stream>>>(
      a, b, match_ids, cost, P, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
