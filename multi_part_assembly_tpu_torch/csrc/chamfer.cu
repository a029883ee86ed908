// Chamfer kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas chamfer kernels of the JAX package
// (multi_part_assembly_tpu/ops/chamfer.py):
//   mpa_chamfer_nn   <- _fused_parts_fwd_kernel (:483, whole shape) and
//                       _fused_diag_fwd_kernel (:556, part i vs part i)
//   mpa_chamfer_bwd  <- _fused_parts_bwd_kernel (:632) and
//                       _fused_diag_bwd_kernel (:687)
//   mpa_nn_parts     <- _nn_parts_kernel (:284), the unfused route's
//                       part-structured nearest neighbour, one direction
//   mpa_nn_dir       <- _nn_kernel (:110), the nearest neighbour of
//                       [B, N1, 3] in [B, N2, 3] behind chamfer_distance
//
// Layout: part clouds are [B, P, N, 3] f32, C-contiguous; valid parts are a
// prefix of the part axis (n_parts[b] of them).  mpa_chamfer_nn's witnesses
// are flat indices into the other cloud viewed as [P * N] (-1 at padded
// parts); mpa_nn_parts writes the JAX numbering part * Npad + local (0 at
// padded parts), which the unfused backward consumes.  The three nearest-
// neighbour kernels share one device-side scan (scan_targets).
//
// What bounds them on the card, and what the design does about it:
//   - The forward is bound by FP32 issue: every (query, target) pair costs
//     three subtractions, three products, two additions and a compare, and
//     the whole-shape mode visits (n_p * N)^2 pairs per shape.  Each thread
//     owns one query point in registers; target points are staged in
//     shared-memory tiles that all threads of the block read at the same
//     address (a broadcast, no bank conflicts), so device-memory traffic is
//     one read of the target cloud per block.  Blocks of padded parts exit
//     at once, so the work follows the valid part count, as on the TPU.
//     The TPU's MXU devices (the K=48 bf16 split packing, y-part grouping,
//     scalar-prefetched tile lists; B7's HIGHEST matmul and B8's K=8
//     augmented matmul, both of the form |x|^2 + |y|^2 - 2 x.y) have no
//     counterpart here.  B8 does the work of one direction of the
//     whole-shape mode; B7 visits N1 * N2 pairs per cloud.
//   - The backward is bound by memory and atomics: one gather of the
//     witness, one plain update of the query's own gradient and three
//     atomicAdds into the witness's gradient per point.
//
// Numerics: the distance is (dx*dx + dy*dy) + dz*dz with every operation
// rounded on its own (__fmul_rn / __fadd_rn cannot be contracted into an
// FMA), the same expression, in the same order, as the plain PyTorch
// version in ops/chamfer.py.  Distances therefore agree bit for bit, and a
// query updates its minimum only on a strict '<' while it walks the targets
// in ascending flat order: ties go to the first hit, the rule the TPU
// kernels keep (ops/chamfer.py:530-549) and torch.min's.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // query points per block
constexpr int kTile = 1024;    // target points per shared-memory tile
constexpr int kMaxGridYZ = 65535;  // CUDA's limit on gridDim.y and .z

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Walks target points [t_begin, t_end) of `tgt` ([*, 3] f32) in ascending
// order through the shared-memory tile and keeps each thread's first strict
// minimum in best / best_w.  Every thread of the block calls it (it holds
// barriers); `active` is false for the threads past the query axis' ragged
// edge, which help load the tiles and compare nothing.
__device__ __forceinline__ void scan_targets(float qx, float qy, float qz,
                                             bool active,
                                             const float* __restrict__ tgt,
                                             int t_begin, int t_end,
                                             float* tile, float& best,
                                             int& best_w) {
  for (int base = t_begin; base < t_end; base += kTile) {
    const int count = min(kTile, t_end - base);
    __syncthreads();  // the previous tile is no longer read
    const float* src = tgt + (long long)base * 3;
    for (int k = threadIdx.x; k < count * 3; k += kThreads) tile[k] = src[k];
    __syncthreads();
    if (active) {
      for (int k = 0; k < count; ++k) {
        const float d = sqdist(qx, qy, qz, tile[3 * k], tile[3 * k + 1],
                               tile[3 * k + 2]);
        if (d < best) {
          best = d;
          best_w = base + k;
        }
      }
    }
  }
}

// grid (ceil(N / kThreads), P, B).  Block (x, i, b) serves query points
// [x * kThreads, ...) of part i of shape b.
__global__ void __launch_bounds__(kThreads)
chamfer_nn_kernel(const float* __restrict__ query,
                  const float* __restrict__ target,
                  const int* __restrict__ n_parts,
                  float* __restrict__ dist, int* __restrict__ witness,
                  int P, int N, int diagonal) {
  __shared__ float tile[kTile * 3];
  const int b = blockIdx.z;
  const int i = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int n_p = min(max(n_parts[b], 0), P);
  const long long qrow = ((long long)b * P + i) * N;

  if (i >= n_p) {  // padded part: distance 0, witness -1
    if (n < N) {
      dist[qrow + n] = 0.0f;
      witness[qrow + n] = -1;
    }
    return;  // uniform over the block: no thread reaches a barrier
  }

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (n < N) {
    const float* q = query + (qrow + n) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const int t_begin = diagonal ? i * N : 0;
  const int t_end = diagonal ? (i + 1) * N : n_p * N;
  float best = CUDART_INF_F;
  int best_w = -1;
  scan_targets(qx, qy, qz, n < N, target + (long long)b * P * N * 3,
               t_begin, t_end, tile, best, best_w);
  if (n < N) {
    dist[qrow + n] = best;
    witness[qrow + n] = best_w;
  }
}

// B8.  grid (ceil(N / kThreads), P, nb) over shapes [b0, b0 + nb): block
// (x, i, b) serves query points [x * kThreads, ...) of part i of shape
// b0 + b against every valid target part, scanned in ascending flat order.
// Blocks of padded parts write 0 and 0 and exit.  The witness is stored in
// the JAX numbering (w / N) * npad + w % N.  The clamp at 0 keeps the JAX
// contract; the distance here is a sum of squares and never below 0.
__global__ void __launch_bounds__(kThreads)
nn_parts_kernel(const float* __restrict__ query,
                const float* __restrict__ target,
                const int* __restrict__ n_parts, float* __restrict__ dist,
                int* __restrict__ idx, int P, int N, int npad) {
  __shared__ float tile[kTile * 3];
  const int b = blockIdx.z;
  const int i = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int n_p = min(max(n_parts[b], 0), P);
  const long long qrow = ((long long)b * P + i) * N;

  if (i >= n_p) {  // padded part: distance 0, index 0 (the JAX kernel's)
    if (n < N) {
      dist[qrow + n] = 0.0f;
      idx[qrow + n] = 0;
    }
    return;  // uniform over the block: no thread reaches a barrier
  }

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (n < N) {
    const float* q = query + (qrow + n) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  float best = CUDART_INF_F;
  int best_w = 0;
  scan_targets(qx, qy, qz, n < N, target + (long long)b * P * N * 3, 0,
               n_p * N, tile, best, best_w);
  if (n < N) {
    dist[qrow + n] = fmaxf(best, 0.0f);
    idx[qrow + n] = (best_w / N) * npad + best_w % N;
  }
}

// B7.  grid (ceil(N1 / kThreads), nb) over clouds [b0, b0 + nb): block
// (x, b) serves query points [x * kThreads, ...) of cloud b0 + b and scans
// all N2 target points of the same cloud.  The JAX kernel pads the target
// axis with far points and clips its index to N2 - 1; a scan of exactly N2
// points needs neither.  Offsets are 64-bit: the dense repulsion route
// holds B * P * P clouds.
__global__ void __launch_bounds__(kThreads)
nn_dir_kernel(const float* __restrict__ x, const float* __restrict__ y,
              float* __restrict__ dist, int* __restrict__ idx, int N1,
              int N2) {
  __shared__ float tile[kTile * 3];
  const long long b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const long long qrow = b * N1;

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (n < N1) {
    const float* q = x + (qrow + n) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  float best = CUDART_INF_F;
  int best_w = 0;
  scan_targets(qx, qy, qz, n < N1, y + b * N2 * 3, 0, N2, tile, best,
               best_w);
  if (n < N1) {
    dist[qrow + n] = fmaxf(best, 0.0f);
    idx[qrow + n] = best_w;
  }
}

// One thread per query point: grad_query[p] += 2 g (q_p - t_w), and the
// negative of the same into grad_target[w].  Points with witness -1 (padded
// parts) contribute nothing.  The own-point update needs no atomic: in one
// launch only thread p writes grad_query[p], and the atomics go to the
// other tensor.
__global__ void __launch_bounds__(kThreads)
chamfer_bwd_kernel(const float* __restrict__ query,
                   const float* __restrict__ target,
                   const int* __restrict__ witness,
                   const float* __restrict__ grad_dist,
                   float* __restrict__ grad_query,
                   float* __restrict__ grad_target,
                   long long total, int PN) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const int w = witness[p];
  if (w < 0) return;
  const long long t = (p / PN) * PN + w;
  const float g2 = __fmul_rn(2.0f, grad_dist[p]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float diff = __fmul_rn(g2, __fsub_rn(query[p * 3 + c],
                                               target[t * 3 + c]));
    grad_query[p * 3 + c] = __fadd_rn(grad_query[p * 3 + c], diff);
    atomicAdd(grad_target + t * 3 + c, -diff);
  }
}

}  // namespace

extern "C" {

// Nearest neighbour of every query point among the valid target parts (all
// of them, or only its own part when diagonal != 0).  Returns a cudaError_t.
int mpa_chamfer_nn(const float* query, const float* target,
                   const int* n_parts, float* dist, int* witness, int B,
                   int P, int N, int diagonal, void* stream) {
  if (B == 0 || P == 0 || N == 0) return 0;
  const dim3 grid((N + kThreads - 1) / kThreads, P, B);
  chamfer_nn_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      query, target, n_parts, dist, witness, P, N, diagonal);
  return (int)cudaGetLastError();
}

// Accumulates one direction's gradient into grad_query and grad_target
// (both zero-initialised or holding the other direction's terms).
int mpa_chamfer_bwd(const float* query, const float* target,
                    const int* witness, const float* grad_dist,
                    float* grad_query, float* grad_target, int B, int P,
                    int N, void* stream) {
  const long long total = (long long)B * P * N;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  chamfer_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      query, target, witness, grad_dist, grad_query, grad_target, total,
      P * N);
  return (int)cudaGetLastError();
}

// B8: one direction of the unfused route's part-structured nearest
// neighbour.  Shapes go in launches of at most kMaxGridYZ (gridDim.z).
int mpa_nn_parts(const float* query, const float* target, const int* n_parts,
                 float* dist, int* idx, int B, int P, int N, int npad,
                 void* stream) {
  if (B == 0 || P == 0 || N == 0) return 0;
  for (long long b0 = 0; b0 < B; b0 += kMaxGridYZ) {
    const int nb = (int)std::min<long long>(kMaxGridYZ, B - b0);
    const long long off = b0 * P * N;
    const dim3 grid((N + kThreads - 1) / kThreads, P, nb);
    nn_parts_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        query + off * 3, target + off * 3, n_parts + b0, dist + off,
        idx + off, P, N, npad);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// B7: nearest neighbour of each of x's [B, N1] points among y's [B, N2]
// points of the same cloud (N2 >= 1).  Clouds go in launches of at most
// kMaxGridYZ (gridDim.y).
int mpa_nn_dir(const float* x, const float* y, float* dist, int* idx, int B,
               int N1, int N2, void* stream) {
  if (B == 0 || N1 == 0) return 0;
  if (N2 <= 0) return (int)cudaErrorInvalidValue;
  for (long long b0 = 0; b0 < B; b0 += kMaxGridYZ) {
    const int nb = (int)std::min<long long>(kMaxGridYZ, B - b0);
    const dim3 grid((N1 + kThreads - 1) / kThreads, nb);
    nn_dir_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x + b0 * N1 * 3, y + b0 * N2 * 3, dist + b0 * N1, idx + b0 * N1, N1,
        N2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
