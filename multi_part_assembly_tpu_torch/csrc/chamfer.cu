// Chamfer kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas chamfer kernels of the JAX package
// (multi_part_assembly_tpu/ops/chamfer.py):
//   mpa_chamfer_pair <- _fused_parts_fwd_kernel (:483, whole shape, B1) and
//                       _fused_diag_fwd_kernel (:556, part i vs part i, B3),
//                       both launched by _fused_parts_fwd_pallas (:793);
//                       both directions in one main launch
//   mpa_chamfer_grad <- _fused_parts_bwd_kernel (:632, whole shape, B2) and
//                       _fused_diag_bwd_kernel (:687, B4), both launched by
//                       _fused_parts_bwd_pallas (:866); both directions in
//                       one launch
//   mpa_nn_parts     <- _nn_parts_kernel (:284), launched by
//                       _nn_parts_pallas (:330): the unfused route's
//                       part-structured nearest neighbour, one direction a
//                       launch (B8)
//   mpa_nn_dir       <- _nn_kernel (:110), the nearest neighbour of
//                       [B, N1, 3] in [B, N2, 3] behind chamfer_distance
//
// Layout: part clouds are [B, P, N, 3] f32, C-contiguous; valid parts are a
// prefix of the part axis (n_parts[b] of them).  mpa_chamfer_pair's
// witnesses are flat indices into the other cloud viewed as [P * N] (-1 at
// padded parts); mpa_nn_parts writes the JAX numbering part * Npad + local
// (0 at padded parts), which the unfused backward consumes.  B8 is B1's
// machinery in one direction (chamfer_pair_kernel<1>); B7 alone keeps
// the thread-per-query scan (scan_targets).
//
// What bounds them on the card, and what the design does about it:
//   - B1/B3 are bound by FP32 issue.  A pair costs 8 operations that cannot
//     fuse into FMAs (three subtractions, three products, two additions)
//     plus one minimum for each direction: 10 operations, and each pair is
//     counted once because one distance serves both directions, as in the
//     TPU kernel ("one distance pass, both directions").  The peak for such
//     operations is 33.5e12 a second (half the 67 TFLOP/s FP32 figure,
//     which counts an FMA as two).  The design: both directions in one pass,
//     and the inner loop spends on a pair just its distance and one fminf
//     for each direction: witnesses are tracked per aligned group of 8
//     candidates and resolved to the first hit in the unpack (the column
//     minimum reduced across the warp by a reduce-scatter of packed keys,
//     then across the block by a shared-memory atomicMin); kQPT query
//     points per thread in registers, so one broadcast LDS.128 of a target
//     point feeds kQPT pairs; equal work units of (shape, x-part,
//     y-part) pairs, listed on the card, walked by a persistent grid, with
//     no block spent on a padded part; target slices copied by cp.async
//     into a second stage while the first is computed; and, when the
//     caller asks for it, the JAX package's exact part-pair pruning
//     (kPruned), which drops pairs that can neither win nor tie.  No
//     tensor cores, on purpose: wgmma would compute |x|^2 + |y|^2 - 2 x.y,
//     which is not bit-equal to the direct-difference form and flips
//     witnesses at near-ties.  The TPU's
//     MXU devices (K=48 bf16 split packing, y-part grouping; B7's HIGHEST
//     matmul and B8's K=8 augmented matmul) have no counterpart here.
//   - B8 is bound by FP32 issue too, but its contract, kept from the JAX
//     package, is one direction a launch, and the unfused route calls it
//     twice: every pair distance is computed once a launch, 9 operations
//     (the distance's 8 and one minimum).  The design is B1's with the
//     column direction compiled out (chamfer_pair_kernel<1>: no
//     column keys, no reduce-scatter, no second key array, no column
//     minimum a pair), the dense work list of chamfer_prep_kernel, and an
//     unpack (nn_unpack_kernel) that resolves each group key to its first
//     hit and writes the JAX numbering.  Padded parts and the padded
//     one-part shapes of the diagonal form get no units.
//   - B7 (scan_targets) gives each thread one query point and scans
//     shared-memory tiles of targets, one direction a launch.  It reaches
//     half its bound and was left as it is.
//   - B2/B4 are bound by bytes: each valid point's coordinates, witnesses
//     and cotangents read once and its gradients written once, and the
//     zero gradient of every padded point written once.  The design: the
//     owner computes.  One block owns a chunk of one part's gradient rows,
//     of dx and (when asked for) dy, accumulates them in shared memory and
//     writes them whole, so there is no memset, no global atomic and no
//     read-modify-write in device memory; a block of a padded part writes
//     its zeros and exits.  Its cross terms come from a walk over the
//     witnesses that can point into its part, both directions in the same
//     rounds (16-byte loads, the next round in flight): the TPU kernel's
//     structure (one grid step owns one shape's dx and dy, both
//     directions).  What bounds it in practice is latency: a block is a
//     chain of dependent loads and barriers, so each step issues all its
//     loads together, and the walk's first round is in flight while the own
//     terms are gathered.  The order of each row's sum is fixed, so that
//     the same inputs give the same bits on every launch, as the TPU's
//     sequential grid does: the matches of a round sit in source order
//     (whole shape, where about one witness in n_p matches: a block-wide
//     prefix count places them in a queue in shared memory; diagonal,
//     where nearly every witness matches: as the threads hold them), a
//     bucket of 1024 of them is sorted by owned row with a stable
//     block radix sort (two passes of 5 bits), and one owner thread a row
//     adds its matches in order.  The cost is the sort and a few barriers
//     a bucket, one or two buckets a direction a block on the everyday
//     clouds; a row that many witnesses share (a collapsed cloud) is one
//     thread's chain of additions.  A count-and-scatter grouping for
//     buckets whose rows take few matches was tried and was slower.
//
// Numerics: the distance is (dx*dx + dy*dy) + dz*dz with every operation
// rounded on its own (__fmul_rn / __fadd_rn cannot be contracted into an
// FMA; the build adds -fmad=false), the same expression, in the same order,
// as the plain PyTorch version in ops/chamfer.py.  Distances therefore
// agree bit for bit, and witnesses follow the first-hit rule: among equal
// minima the smallest flat index wins, the rule the TPU kernels keep
// (ops/chamfer.py:530-549) and torch.min's.  B1/B3 get it from the order of
// packed keys, B7/B8 from a strict '<' while walking targets in ascending
// order.  B2/B4 form each gradient term as the plain version does,
// __fmul_rn(2 g, __fsub_rn(q, t)), and add a row's terms in the plain
// version's order (its own term, then its sources in ascending order), one
// rounded addition at a time: the same bits on every launch, and the bits
// of the plain version wherever its index_add_ adds in index order, as it
// does on the CPU.

#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

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
// minimum in best / best_w (B7).  Every thread of the block calls it (it
// holds barriers); `active` is false for the threads past the query axis'
// ragged edge, which help load the tiles and compare nothing.
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

// ---------------------------------------------------------------------------
// B1/B3: both directions of the part-structured chamfer in one pass.
//
// A work unit is one (shape b, x-part i, y-part j) pair of the work list
// (j == i in diagonal mode), cut into query chunks of kQChunk points and
// target slices, so that every unit does the same work and no block is
// spent on a padded part.  chamfer_prep_kernel writes the list on the card
// (count first); chamfer_pair_kernel is a persistent grid that walks it;
// chamfer_unpack_kernel (B8: nn_unpack_kernel) turns the packed minima
// into distances and witnesses.
//
// Minima are packed as (float bits of d) << 32 | index.  Since d >= +0,
// the unsigned order of two keys is the lexicographic order of (d, index),
// so the minimum key holds the smallest index among equal distances
// whatever order the units and lanes ran in, and atomicMin merges units
// deterministically.  The index is that of an aligned group of 8
// candidates; the unpack resolves it to the first hit.
// ---------------------------------------------------------------------------

constexpr int kPairThreads = 128;
constexpr int kQPT = 8;                        // query points per thread
constexpr int kQChunk = kPairThreads * kQPT;   // query points per unit
constexpr int kGroup = 8;                      // candidates a witness group
constexpr int kMaxSlice = 512;                 // target points per stage
constexpr int kMinSlice = 32;                  // ... and the least a unit takes
constexpr int kWaves = 8;                      // rounds of the grid to fill
constexpr int kPrepThreads = 1024;
constexpr unsigned long long kNoKey = ~0ull;
// relative slack of the pruning bounds (ops/chamfer.py:778 of the JAX
// package): it covers the rounding of the centroid and radius reductions
constexpr float kPruneSlack = 1e-4f;

enum PairMode { kDense = 0, kPruned = 1, kDiagonal = 2 };

__device__ __forceinline__ unsigned long long pack_key(float d, int w) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)w;
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return b < a ? b : a;
}

__device__ __forceinline__ unsigned long long shfl_xor64(unsigned long long v,
                                                         int mask) {
  return __shfl_xor_sync(0xffffffffu, v, mask);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct Unit {
  int b, i, j;  // shape, x-part, y-part
  int q0;       // first query point of the chunk
  int t0, tcnt; // first target point of the slice, and its length
};

// How a block cuts the list's part pairs into units, computed alike by
// every block from the list's count: target slices of at most kMaxSlice
// points, short enough that the units fill kWaves rounds of the grid (so
// the last, partial round costs little), but not below kMinSlice.
struct Split {
  int n_qc, n_ts, slice;
  long long total;
};

__device__ __forceinline__ Split split_units(int count, int N) {
  Split s;
  s.n_qc = (N + kQChunk - 1) / kQChunk;
  const long long pairs = (long long)count * s.n_qc;
  const long long want = (long long)kWaves * gridDim.x;
  const int most = (N + kMinSlice - 1) / kMinSlice;
  const int least = (N + kMaxSlice - 1) / kMaxSlice;
  int n_ts = pairs > 0 ? (int)min((want + pairs - 1) / pairs, (long long)most)
                       : least;
  n_ts = max(n_ts, least);
  s.slice = ((N + n_ts - 1) / n_ts + kGroup - 1) / kGroup * kGroup;
  s.n_ts = (N + s.slice - 1) / s.slice;
  s.total = pairs * s.n_ts;
  return s;
}

__device__ __forceinline__ Unit decode_unit(const int* __restrict__ list,
                                            long long u, int P, int N,
                                            const Split& s) {
  const int per = s.n_qc * s.n_ts;
  const int pair = list[u / per];
  const int r = (int)(u % per);
  Unit w;
  w.b = pair / (P * P);
  w.i = (pair / P) % P;
  w.j = pair % P;
  w.q0 = (r / s.n_ts) * kQChunk;
  w.t0 = (r % s.n_ts) * s.slice;
  w.tcnt = min(s.slice, N - w.t0);
  return w;
}

// Starts the copy of a unit's target slice ([tcnt, 3] f32) into a stage of
// 16-byte points (w unused), one cp.async group per thread.
__device__ __forceinline__ void load_slice(float4* stage,
                                           const float* __restrict__ y,
                                           const Unit& w, int P, int N) {
  const float* src = y + (((long long)w.b * P + w.j) * N + w.t0) * 3;
  for (int e = threadIdx.x; e < w.tcnt * 3; e += kPairThreads) {
    const int p = e / 3;
    cp_async4(reinterpret_cast<float*>(stage + p) + (e - 3 * p), src + e);
  }
  cp_async_commit();
}

// After the loop over one group of kGroup targets, lane l holds in ck[k]
// the column minimum of target k over its own kQPT queries.  A
// reduce-scatter over lane bits 2, 1, 0 (4 + 2 + 1 exchanges) leaves lane l
// with target l & 7 reduced over 8 lanes; two more exchanges over bits 3
// and 4 finish the warp.  Lanes 0-7 then hold targets 0-7.
__device__ __forceinline__ unsigned long long reduce_columns(
    unsigned long long (&ck)[kGroup], int lane) {
  const bool b2 = lane & 4, b1 = lane & 2, b0 = lane & 1;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const unsigned long long send = b2 ? ck[m] : ck[m + 4];
    const unsigned long long keep = b2 ? ck[m + 4] : ck[m];
    ck[m] = umin64(keep, shfl_xor64(send, 4));
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const unsigned long long send = b1 ? ck[m] : ck[m + 2];
    const unsigned long long keep = b1 ? ck[m + 2] : ck[m];
    ck[m] = umin64(keep, shfl_xor64(send, 2));
  }
  unsigned long long v = umin64(b0 ? ck[1] : ck[0],
                                shfl_xor64(b0 ? ck[0] : ck[1], 1));
  v = umin64(v, shfl_xor64(v, 8));
  return umin64(v, shfl_xor64(v, 16));
}

// One block per shape: sets the shape's keys of its valid parts to kNoKey
// (in key2 too unless it is null), then appends the shape's part pairs to
// the work list `work` ([count, pair...], pair = (b * P + i) * P + j): every
// i, j < n_p (kDense), i == j (kDiagonal), or the pairs that the exact
// triangle-inequality rule keeps (kPruned, the JAX package's
// _forward_pairs at gy = 1, ops/chamfer.py:740-790): with centroids c,
// radii r, D = |c1_i - c2_j| and rsum = r1_i + r2_j, pair (i, j) is kept
// when lb_ij <= ub1_i or lb_ij <= ub2_j, where ub = D + rsum, lb =
// max(D - rsum - slack (D + rsum), 0), ub1_i = min_j ub_ij and ub2_j =
// min_i ub_ij.  A dropped pair's distances all exceed the nearest-neighbour
// distance of every point it could serve, so it can neither win nor tie.
__global__ void __launch_bounds__(kPrepThreads)
chamfer_prep_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const int* __restrict__ n_parts,
                    unsigned long long* __restrict__ key1,
                    unsigned long long* __restrict__ key2,
                    int* __restrict__ work, int P, int N, int mode) {
  extern __shared__ float bounds[];  // kPruned: c1, c2 [P, 3]; r1, r2,
                                     // ub1, ub2 [P]
  const int b = blockIdx.x;
  const int n_p = min(max(n_parts[b], 0), P);
  const long long off = (long long)b * P * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kPrepThreads / 32;
  for (long long e = threadIdx.x; e < (long long)n_p * N; e += kPrepThreads) {
    key1[off + e] = kNoKey;
    if (key2) key2[off + e] = kNoKey;
  }
  float* c1 = bounds;
  float* c2 = bounds + 3 * P;
  float* r1 = bounds + 6 * P;
  float* r2 = bounds + 7 * P;
  float* ub1 = bounds + 8 * P;
  float* ub2 = bounds + 9 * P;
  if (mode == kPruned) {
    // one warp per part cloud: centroid, then radius
    for (int c = warp; c < 2 * n_p; c += kWarps) {
      const int part = c < n_p ? c : c - n_p;
      const float* pts = (c < n_p ? x : y) + (off + (long long)part * N) * 3;
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll 4
      for (int n = lane; n < N; n += 32) {
        sx = __fadd_rn(sx, pts[3 * n]);
        sy = __fadd_rn(sy, pts[3 * n + 1]);
        sz = __fadd_rn(sz, pts[3 * n + 2]);
      }
      for (int m = 16; m > 0; m >>= 1) {
        sx = __fadd_rn(sx, __shfl_xor_sync(0xffffffffu, sx, m));
        sy = __fadd_rn(sy, __shfl_xor_sync(0xffffffffu, sy, m));
        sz = __fadd_rn(sz, __shfl_xor_sync(0xffffffffu, sz, m));
      }
      const float cx = __fdiv_rn(sx, (float)N);
      const float cy = __fdiv_rn(sy, (float)N);
      const float cz = __fdiv_rn(sz, (float)N);
      float r = 0.0f;
#pragma unroll 4
      for (int n = lane; n < N; n += 32)
        r = fmaxf(r, sqdist(pts[3 * n], pts[3 * n + 1], pts[3 * n + 2], cx,
                            cy, cz));
      for (int m = 16; m > 0; m >>= 1)
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, m));
      if (lane == 0) {
        float* cc = (c < n_p ? c1 : c2) + 3 * part;
        cc[0] = cx;
        cc[1] = cy;
        cc[2] = cz;
        (c < n_p ? r1 : r2)[part] = __fsqrt_rn(r);
      }
    }
    __syncthreads();
    // ub1_i over j (threads 0..n_p-1), ub2_j over i (threads n_p..2n_p-1)
    for (int t = threadIdx.x; t < 2 * n_p; t += kPrepThreads) {
      float best = CUDART_INF_F;
      for (int k = 0; k < n_p; ++k) {
        const int i = t < n_p ? t : k, j = t < n_p ? k : t - n_p;
        const float D = __fsqrt_rn(sqdist(c1[3 * i], c1[3 * i + 1],
                                          c1[3 * i + 2], c2[3 * j],
                                          c2[3 * j + 1], c2[3 * j + 2]));
        best = fminf(best, __fadd_rn(D, __fadd_rn(r1[i], r2[j])));
      }
      (t < n_p ? ub1 : ub2)[t < n_p ? t : t - n_p] = best;
    }
    __syncthreads();
  }
  if (warp != 0) return;
  const int n_cand = mode == kDiagonal ? n_p : n_p * n_p;
  auto kept = [&](int e, int& i, int& j) {
    i = mode == kDiagonal ? e : e / max(n_p, 1);
    j = mode == kDiagonal ? e : e - i * n_p;
    if (e >= n_cand) return false;
    if (mode != kPruned) return true;
    const float D = __fsqrt_rn(sqdist(c1[3 * i], c1[3 * i + 1], c1[3 * i + 2],
                                      c2[3 * j], c2[3 * j + 1],
                                      c2[3 * j + 2]));
    const float rsum = __fadd_rn(r1[i], r2[j]);
    const float slack = __fmul_rn(kPruneSlack, __fadd_rn(D, rsum));
    const float lb = fmaxf(__fsub_rn(__fsub_rn(D, rsum), slack), 0.0f);
    return lb <= ub1[i] || lb <= ub2[j];
  };
  int count = 0;
  for (int e0 = 0; e0 < n_cand; e0 += 32) {
    int i, j;
    count += __popc(__ballot_sync(0xffffffffu, kept(e0 + lane, i, j)));
  }
  int base = 0;
  if (lane == 0 && count > 0) base = atomicAdd(work, count);
  base = __shfl_sync(0xffffffffu, base, 0);
  int* list = work + 1;
  for (int e0 = 0; e0 < n_cand; e0 += 32) {
    int i, j;
    const bool k = kept(e0 + lane, i, j);
    const unsigned bal = __ballot_sync(0xffffffffu, k);
    if (k)
      list[base + __popc(bal & ((1u << lane) - 1u))] = (b * P + i) * P + j;
    base += __popc(bal);
  }
}

// Persistent grid over the units of the work list: each block walks a
// contiguous range of them, in list order, so that consecutive units
// usually share their queries (same shape, x-part and chunk; only the
// y-part or the slice moves on) and the queries and row minima stay in
// registers across them.  Each thread holds kQPT consecutive query points
// of the unit's chunk in registers (flat indices qgroup .. qgroup + 7, an
// aligned group of 8 in its part) and walks the target slice, staged in
// shared memory as float4 points that every lane reads at the same address
// (one broadcast LDS.128 per target for kQPT pairs).  The row
// minimum of every query is taken over a group of kGroup targets and kept,
// with the group, when it beats the best so far (a strict '<', so the
// first group wins a tie).  With kDirs == 2 (B1/B3) the same pair distance
// also serves the other direction: the column minimum of every target is
// taken over the thread's kQPT queries, packed with qgroup, and
// reduced over the warp by reduce_columns and over the block by a
// shared-memory atomicMin; the columns go to key2 by atomicMin at the end
// of every unit.  With kDirs == 1 (B8) all of that is compiled out.  The
// rows go to key1 when the queries change.  A key thus names an aligned
// group of 8 candidates, and the unpack finds the first of them at the
// key's distance: the first hit overall, since the smallest group holding
// a minimum holds the smallest index at that minimum.  The next unit's
// slice is copied by cp.async into the other stage while this one is
// computed.  Query slots past N and target slots past the slice hold NaN:
// fminf ignores NaN and every comparison with it is false, so they never
// win.  (Sixteen queries a thread, in blocks of 64, ran no faster for B8.)
template <int kDirs>
__global__ void __launch_bounds__(kPairThreads, 4)
chamfer_pair_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const int* __restrict__ work,
                    unsigned long long* __restrict__ key1,
                    unsigned long long* __restrict__ key2, int P, int N) {
  static_assert(kQPT == kGroup, "a column key names a group of kGroup "
                "queries");
  __shared__ float4 stage[2][kMaxSlice];
  __shared__ unsigned long long col[kDirs == 2 ? kMaxSlice : 1];
  const Split s = split_units(work[0], N);
  const int* list = work + 1;
  const int lane = threadIdx.x & 31;
  // this block's contiguous range of units, equal to within one
  const long long share = s.total / gridDim.x, extra = s.total % gridDim.x;
  const long long first = blockIdx.x * share + min((long long)blockIdx.x, extra);
  const long long end = first + share + (blockIdx.x < extra ? 1 : 0);
  if (first >= end) return;  // uniform over the block
  Unit cur = decode_unit(list, first, P, N, s);
  load_slice(stage[0], y, cur, P, N);
  float qx[kQPT], qy[kQPT], qz[kQPT], bd[kQPT];
  int bw[kQPT];
  bool fresh = true;  // the queries of `cur` are not loaded yet
  for (long long u = first, it = 0; u < end; ++u, ++it) {
    const long long nu = u + 1;
    Unit nxt = cur;
    if (nu < end) {
      nxt = decode_unit(list, nu, P, N, s);
      load_slice(stage[(it + 1) & 1], y, nxt, P, N);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    float4* T = stage[it & 1];
    const int tpad = (cur.tcnt + kGroup - 1) / kGroup * kGroup;
    for (int t = threadIdx.x; t < tpad; t += kPairThreads) {
      if (t >= cur.tcnt)
        T[t] = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, 0.0f);
      if (kDirs == 2) col[t] = kNoKey;
    }
    __syncthreads();

    const long long qrow = ((long long)cur.b * P + cur.i) * N;
    const int n0 = cur.q0 + threadIdx.x * kQPT;  // first query of the thread
    if (fresh) {
#pragma unroll
      for (int q = 0; q < kQPT; ++q) {
        qx[q] = qy[q] = qz[q] = CUDART_NAN_F;
        if (n0 + q < N) {
          const float* p = x + (qrow + n0 + q) * 3;
          qx[q] = p[0];
          qy[q] = p[1];
          qz[q] = p[2];
        }
        bd[q] = CUDART_INF_F;
        bw[q] = 0;
      }
    }
    const int qgroup = cur.i * N + n0;
    const int wbase = cur.j * N + cur.t0;  // flat index of the slice's 1st
    for (int g = 0; g < tpad; g += kGroup) {
      unsigned long long ck[kGroup];
      float gm[kQPT];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const float4 t = T[g + k];
        float cd = 0.0f;
#pragma unroll
        for (int q = 0; q < kQPT; ++q) {
          const float d = sqdist(qx[q], qy[q], qz[q], t.x, t.y, t.z);
          gm[q] = k == 0 ? d : fminf(gm[q], d);
          if (kDirs == 2) cd = q == 0 ? d : fminf(cd, d);
        }
        if (kDirs == 2) ck[k] = pack_key(cd, qgroup);
      }
#pragma unroll
      for (int q = 0; q < kQPT; ++q) {
        if (gm[q] < bd[q]) {
          bd[q] = gm[q];
          bw[q] = wbase + g;
        }
      }
      if (kDirs == 2) {
        const unsigned long long v = reduce_columns(ck, lane);
        if (lane < kGroup) atomicMin(&col[g + lane], v);
      }
    }
    if (kDirs == 2) {
      __syncthreads();
      const long long trow = ((long long)cur.b * P + cur.j) * N + cur.t0;
      for (int t = threadIdx.x; t < cur.tcnt; t += kPairThreads)
        atomicMin(&key2[trow + t], col[t]);
    }
    // the next unit of the range has the same queries when only its y-part
    // or slice differs: the row minima stay in registers until then
    fresh = nu >= end || nxt.b != cur.b || nxt.i != cur.i || nxt.q0 != cur.q0;
    if (fresh) {
#pragma unroll
      for (int q = 0; q < kQPT; ++q) {
        if (n0 + q < N)
          atomicMin(&key1[qrow + n0 + q], pack_key(bd[q], bw[q]));
      }
    }
    __syncthreads();  // the stage (and col) are rewritten next
    cur = nxt;
  }
}

// The witness behind key k (distance bits << 32 | the first flat index of
// an aligned group of up to kGroup candidates among `other`'s [P * N]
// points): the first candidate whose distance to `self`, recomputed as the
// pair kernel computed it (the x point first, `self_is_x` telling which
// that is), equals the key's distance d.
__device__ __forceinline__ int first_hit(unsigned long long k,
                                         const float* __restrict__ self,
                                         const float* __restrict__ other,
                                         bool self_is_x, int N, float& d) {
  d = __uint_as_float((unsigned)(k >> 32));
  const int base = (int)(unsigned)(k & 0xffffffffu);
  const int local = base % N;
  const float* o = other + (long long)base * 3;
  for (int c = 0; c < kGroup && local + c < N; ++c, o += 3) {
    const float dc = self_is_x
                         ? sqdist(self[0], self[1], self[2], o[0], o[1], o[2])
                         : sqdist(o[0], o[1], o[2], self[0], self[1], self[2]);
    if (dc == d) return base + c;
  }
  return base;
}

// keys [2, B, P, N] -> dist1, dist2 [B, P, N] and witness1, witness2; 0
// and -1 at padded parts.  A key holds the distance (high word) and the
// first flat index of an aligned group of up to kGroup candidates in the
// other cloud (low word); the witness is the first candidate whose
// distance, recomputed as the pair kernel computed it (x point first),
// equals the key's.
__global__ void __launch_bounds__(kThreads)
chamfer_unpack_kernel(const unsigned long long* __restrict__ keys,
                      const int* __restrict__ n_parts,
                      const float* __restrict__ x,
                      const float* __restrict__ y, float* __restrict__ d1,
                      float* __restrict__ d2, int* __restrict__ w1,
                      int* __restrict__ w2, long long M, int P, int N) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= 2 * M) return;
  const bool second = e >= M;
  const long long p = second ? e - M : e;
  const int b = (int)(p / ((long long)P * N));
  const int i = (int)((p / N) % P);
  float d = 0.0f;
  int w = -1;
  if (i < min(max(n_parts[b], 0), P))
    w = first_hit(keys[e], (second ? y : x) + p * 3,
                  (second ? x : y) + (long long)b * P * N * 3, !second, N, d);
  (second ? d2 : d1)[p] = d;
  (second ? w2 : w1)[p] = w;
}

// B8's unpack: keys [B, P, N] of one direction -> dist [B, P, N] (clamped
// at 0, which keeps the JAX contract: a sum of squares is never below 0)
// and idx in the JAX numbering (w / N) * npad + w % N; 0 and 0 at padded
// parts, the JAX kernel's.
__global__ void __launch_bounds__(kThreads)
nn_unpack_kernel(const unsigned long long* __restrict__ keys,
                 const int* __restrict__ n_parts,
                 const float* __restrict__ query,
                 const float* __restrict__ target, float* __restrict__ dist,
                 int* __restrict__ idx, long long M, int P, int N, int npad) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= M) return;
  const int b = (int)(p / ((long long)P * N));
  const int i = (int)((p / N) % P);
  float d = 0.0f;
  int w = 0;
  if (i < min(max(n_parts[b], 0), P)) {
    const int hit = first_hit(keys[p], query + p * 3,
                              target + (long long)b * P * N * 3, true, N, d);
    d = fmaxf(d, 0.0f);
    w = (hit / N) * npad + hit % N;
  }
  dist[p] = d;
  idx[p] = w;
}

// Blocks of chamfer_pair_kernel<kDirs> that fit on the current device at
// once, asked once per device and instantiation.
template <int kDirs>
cudaError_t resident_pair_blocks(int* out) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *out = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chamfer_pair_kernel<kDirs>, kPairThreads, 0);
  if (err != cudaSuccess) return err;
  *out = sms * std::max(per_sm, 1);
  if (dev < kMaxDevices) cached[dev] = *out;
  return cudaSuccess;
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

// ---------------------------------------------------------------------------
// B2/B4: the gradient of both directions from the forward's witnesses.
//
// d1_p = |x_p - y_w1(p)|^2 and d2_q = |y_q - x_w2(q)|^2 give
//   dx_i = 2 g1_i (x_i - y_w1(i)) + sum over q with w2(q) = i of
//          2 g2_q (x_i - y_q)
// and dy likewise with the roles swapped.  Each term is formed as the plain
// version forms it; 2 g2_q (x_i - y_q) is bit for bit the negative of the
// plain version's 2 g2_q (y_q - x_i).
// ---------------------------------------------------------------------------

constexpr int kGradThreads = 256;
// blocks resident on an SM: a thread may use 128 registers, which keeps a
// round's loads in flight without spilling (measured faster than four
// blocks at 64 registers)
constexpr int kGradBlocksPerSM = 2;
// owned points a block at most: the dx and dy accumulators ([C, 3] f32,
// each padded to a 16-byte phase), the staged owned points, the match
// queues (whole shape) and the buckets fit two blocks an SM (grad_smem: at
// most about 104 KB a block)
constexpr int kGradChunk = 1020;
constexpr int kOwnPer = (kGradChunk + kGradThreads - 1) / kGradThreads;
// The cross terms reach their owned rows through buckets: kBucket matches
// at a time (kBucketItems a thread) are sorted by owned row, stably, and
// one owner thread a row adds its matches in source order.
constexpr int kBucketItems = 4;
constexpr int kBucket = kGradThreads * kBucketItems;
constexpr int kWalkSegs = 2;  // whole shape: witness segments a thread a round
// sort keys: (owned row << kSlotBits) | slot in the bucket, sorted on the
// row's bits alone, two passes of 5 bits
constexpr int kSlotBits = 10;
constexpr int kRowBits = 10;
constexpr unsigned kNoRow = (1u << kRowBits) - 1;  // the row of a non-match
constexpr int kRowSlots = 1 << kRowBits;
static_assert(kGradChunk < (int)kNoRow, "owned rows must sort below kNoRow");
static_assert(kBucket == 1 << kSlotBits, "a slot fills the low key bits");
constexpr int kGradWarps = kGradThreads / 32;
using RowSort = cub::BlockRadixSort<unsigned, kGradThreads, kBucketItems,
                                    cub::NullType, 5>;

// Floats of one accumulator of the grad kernel: 3 * C, plus up to 3 of
// phase, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int grad_stride(int C) {
  return (3 * C + 6) / 4 * 4;
}

// The position of a 4-byte aligned pointer within its 16 bytes, in floats.
__device__ __forceinline__ int phase16(const void* p) {
  return (int)(((unsigned long long)p >> 2) & 3);
}

// Copies n floats of shared memory s into device memory g, where s has the
// same 16-byte phase as g (scalar head and tail, 16-byte body), or writes
// n zeros when s is null.
__device__ __forceinline__ void store_rows(float* __restrict__ g,
                                           const float* s, int n) {
  const int head = min(n, (4 - phase16(g)) & 3);
  const int body = (n - head) >> 2;
  for (int k = threadIdx.x; k < head; k += kGradThreads)
    g[k] = s ? s[k] : 0.0f;
  float4* g4 = reinterpret_cast<float4*>(g + head);
  const float4* s4 = s ? reinterpret_cast<const float4*>(s + head) : nullptr;
  for (int k = threadIdx.x; k < body; k += kGradThreads)
    g4[k] = s ? s4[k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = head + 4 * body + threadIdx.x; k < n; k += kGradThreads)
    g[k] = s ? s[k] : 0.0f;
}

// One direction's own terms: the owned points own, their witnesses w and
// cotangents g (each offset to the chunk's first point; g null when the
// direction has no cotangent), the other cloud's points other (offset to
// the shape), the accumulator acc, and stage, where the owned points are
// copied for the cross terms.
struct OwnDir {
  float* acc;
  float* stage;
  const float* own;
  const float* other;
  const int* w;
  const float* g;
};

// The own terms of kDirs directions, stored (not added) into acc[3 i ..]
// for the owned points i = threadIdx.x + k * kGradThreads: 2 g_i (own_i -
// other_w(i)), 0 without a cotangent.  Every direction's witnesses,
// cotangents and owned points are loaded together, then every target.
template <int kDirs>
__device__ __forceinline__ void own_terms(const OwnDir (&d)[2], int cnt) {
  int wv[kDirs][kOwnPer];
  float gv[kDirs][kOwnPer], p[kDirs][kOwnPer][3], o[kDirs][kOwnPer][3];
#pragma unroll
  for (int r = 0; r < kDirs; ++r) {
#pragma unroll
    for (int k = 0; k < kOwnPer; ++k) {
      const int i = threadIdx.x + k * kGradThreads;
      const bool in = d[r].g && i < cnt;
      wv[r][k] = in ? d[r].w[i] : -1;
      gv[r][k] = in ? d[r].g[i] : 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        p[r][k][c] = i < cnt ? d[r].own[3 * i + c] : 0.0f;
    }
  }
#pragma unroll
  for (int r = 0; r < kDirs; ++r)
#pragma unroll
    for (int k = 0; k < kOwnPer; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        o[r][k][c] =
            wv[r][k] >= 0 ? __ldg(d[r].other + 3 * wv[r][k] + c) : 0.0f;
#pragma unroll
  for (int r = 0; r < kDirs; ++r) {
#pragma unroll
    for (int k = 0; k < kOwnPer; ++k) {
      const int i = threadIdx.x + k * kGradThreads;
      const float gg = __fmul_rn(2.0f, gv[r][k]);
      if (i < cnt) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          d[r].acc[3 * i + c] =
              wv[r][k] >= 0 ? __fmul_rn(gg, __fsub_rn(p[r][k][c], o[r][k][c]))
                            : 0.0f;
          if (d[r].stage) d[r].stage[3 * i + c] = p[r][k][c];
        }
      }
    }
  }
}

// Shared memory of the buckets: the staged terms of one bucket, by slot,
// its slots sorted by row (src; key: the sorted rows), each row's span of
// sorted slots [start, end) (end is 0 between buckets), the warps' partial
// sums of the walk's block scans (two sets, used in turn), and the sort's
// scratch.
struct Buckets {
  float* term;            // [kBucket][3]
  unsigned short* key;    // [kBucket]
  unsigned short* src;    // [kBucket]
  unsigned short* start;  // [kRowSlots]
  unsigned short* end;    // [kRowSlots]
  int* wsum;              // [2][kGradWarps]
  RowSort::TempStorage* sort;
};

// Adds to each owned row i < cnt of acc the terms of the items keyed i, in
// source order: item e of thread t is the source kBucketItems * t + e of a
// stretch walked in ascending order (a non-match is keyed kNoRow), and its
// term is staged at bk.term[3 * slot], slot = kBucketItems * t + e, before
// the call.  A stable sort by row groups the slots, and one owner
// thread a row adds its group in order, so that a row's gradient is its
// own term followed by its sources' terms in ascending order of source, the
// order in which the plain version's index_add_ adds them, whatever the
// timing of the warps.  Every thread of the block calls it; it ends with a
// barrier, after which the buckets' memory may be reused.
__device__ __forceinline__ void bucket_add(float* acc,
                                           const unsigned (&row)[kBucketItems],
                                           int cnt, const Buckets& bk) {
  unsigned key[kBucketItems];
#pragma unroll
  for (int e = 0; e < kBucketItems; ++e)
    key[e] = row[e] << kSlotBits | (threadIdx.x * kBucketItems + e);
  RowSort(*bk.sort).Sort(key, kSlotBits, kSlotBits + kRowBits);
#pragma unroll
  for (int e = 0; e < kBucketItems; ++e) {
    const int s = threadIdx.x * kBucketItems + e;
    bk.key[s] = (unsigned short)(key[e] >> kSlotBits);
    bk.src[s] = (unsigned short)(key[e] & (kBucket - 1));
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kBucketItems; ++e) {
    const int s = threadIdx.x * kBucketItems + e;
    const unsigned k = key[e] >> kSlotBits;
    if (k == kNoRow) continue;
    if (s == 0 || bk.key[s - 1] != k) bk.start[k] = (unsigned short)s;
    if (s == kBucket - 1 || bk.key[s + 1] != k)
      bk.end[k] = (unsigned short)(s + 1);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kOwnPer; ++m) {
    const int i = threadIdx.x + m * kGradThreads;
    if (i >= cnt) continue;
    const int stop = bk.end[i];
    if (stop == 0) continue;
    float a[3] = {acc[3 * i], acc[3 * i + 1], acc[3 * i + 2]};
#pragma unroll 4
    for (int s = bk.start[i]; s < stop; ++s) {
      const float* ts = bk.term + 3 * bk.src[s];
#pragma unroll
      for (int c = 0; c < 3; ++c) a[c] = __fadd_rn(a[c], ts[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[3 * i + c] = a[c];
    bk.end[i] = 0;
  }
  __syncthreads();
}

// The exclusive prefix sum of v over the block's threads, in thread order,
// and the block's total, through the warp sums ws[kGradWarps].  Every
// thread calls it; a caller that calls again without a barrier between
// passes another ws.
__device__ __forceinline__ int block_exclusive(int v, int* ws, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kGradWarps; ++w) {
    const int sw = ws[w];
    before += w < warp ? sw : 0;
    total += sw;
  }
  return before + x - v;
}

// One direction of the cross terms: sources with witnesses w, cotangents g
// and points pts (each offset to source 0), and the owned rows' points own
// (staged) and accumulator acc, both in shared memory.  A source
// q whose witness is owned point i adds 2 g_q (own_i - pts_q) to acc[3 i].
struct GradDir {
  const int* w;
  const float* g;
  const float* pts;
  const float* own;
  float* acc;
};

// The 16-byte segments that hold the witnesses w[0, n): segment s holds
// w[4 s - ph .. 4 s - ph + 3], ph = w's phase.  A segment never crosses a
// page, so the few ints outside [0, n) at either end are read and never
// used.
struct Segments {
  const int4* w4;
  int ph, n4;
  Segments() = default;
  __device__ __forceinline__ Segments(const int* w, int n)
      : w4(reinterpret_cast<const int4*>(w - phase16(w))),
        ph(phase16(w)),
        n4((n + phase16(w) + 3) >> 2) {}
  __device__ __forceinline__ int4 load(int s) const {
    return s < n4 ? __ldg(w4 + s) : make_int4(-1, -1, -1, -1);
  }
};

static_assert(kBucketItems == 4, "a thread's bucket items are one segment");

// The cross terms of kDirs directions over sources [0, n) whose witness
// lies in the owned chunk [lo, lo + cnt), i = w_q - lo.  The walk goes in
// rounds of kGradThreads segments a direction, thread t taking segment
// base + t, so that the block's items are in source order; the first round
// is loaded before the own terms (Walk::first), so that its latency hides
// behind theirs.
//
// Diagonal mode (DirectWalk): nearly every source matches, and a source's
// cotangent and point do not depend on its witness, so a round loads them
// with the witnesses, forms its terms (the owned points come from shared
// memory) and hands them to the buckets as they stand: a round is a
// bucket.
template <int kDirs>
struct DirectWalk {
  Segments seg[kDirs];
  int n, n4, s;  // s: this thread's segment of the round
  int v[kDirs][4];
  float gg[kDirs][4], c[kDirs][4][3];

  __device__ __forceinline__ bool in(int r, int e, int& q) const {
    q = 4 * s + e - seg[r].ph;
    return q >= 0 && q < n;
  }

  __device__ __forceinline__ void load(const GradDir (&d)[2], int base) {
    s = base + threadIdx.x;
#pragma unroll
    for (int r = 0; r < kDirs; ++r) {
      const int4 v4 = seg[r].load(s);
      v[r][0] = v4.x;
      v[r][1] = v4.y;
      v[r][2] = v4.z;
      v[r][3] = v4.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int q;
        const bool ok = in(r, e, q);
        gg[r][e] = ok ? __fmul_rn(2.0f, __ldg(d[r].g + q)) : 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          c[r][e][k] = ok ? __ldg(d[r].pts + 3 * q + k) : 0.0f;
      }
    }
  }

  __device__ __forceinline__ void first(const GradDir (&d)[2], int n_src) {
    n = n_src;
#pragma unroll
    for (int r = 0; r < kDirs; ++r) seg[r] = Segments(d[r].w, n);
    n4 = max(seg[0].n4, seg[kDirs - 1].n4);
    load(d, 0);
  }

  __device__ __forceinline__ void rest(const GradDir (&d)[2], unsigned lo,
                                       unsigned cnt, int2*,
                                       const Buckets& bk) {
    for (int base = 0; base < n4; base += kGradThreads) {
      if (base) load(d, base);
      unsigned key[kDirs][4];
      float t[kDirs][4][3];
      int any = 0;
#pragma unroll
      for (int r = 0; r < kDirs; ++r) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int q;
          const unsigned i = (unsigned)v[r][e] - lo;  // -1, out: >= cnt
          const bool m = in(r, e, q) && i < cnt;
          key[r][e] = m ? i : kNoRow;
          any |= m << r;
#pragma unroll
          for (int k = 0; k < 3; ++k) t[r][e][k] = 0.0f;
          if (m) {
#pragma unroll
            for (int k = 0; k < 3; ++k)
              t[r][e][k] = __fmul_rn(gg[r][e],
                                     __fsub_rn(d[r].own[3 * i + k], c[r][e][k]));
          }
        }
      }
      // a direction with no match in the block skips its bucket
#pragma unroll
      for (int r = 0; r < kDirs; ++r) {
        if (!__syncthreads_or(any >> r & 1)) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = threadIdx.x * 4 + e;
#pragma unroll
          for (int k = 0; k < 3; ++k) bk.term[3 * slot + k] = t[r][e][k];
        }
        bucket_add(d[r].acc, key[r], cnt, bk);
      }
    }
  }
};

// Whole-shape mode (QueuedWalk): about one witness in n_p matches.  A
// round gives each thread kSegs segments a direction (kWalkSegs over both),
// the next round's in flight while one is scanned.  Its matches go, in
// source order, to the direction's queue in shared memory (positions by a
// block-wide prefix count of the threads' matches); a full queue, and the
// last one, is a bucket: its entries' cotangents and points are loaded
// (all of a thread's together) and their terms staged.  A round with more
// matches than the queue holds fills it, flushes it and goes on, so that
// buckets follow source order.  (Loading a match's cotangent and point as
// soon as it is found, and queueing its term, was slower: it lengthens
// every round.)
template <int kDirs>
struct QueuedWalk {
  static constexpr int kSegs = kWalkSegs / kDirs;  // a direction's a round
  static constexpr int kSpan = kSegs * kGradThreads;  // segments a round
  static_assert(kDirs * kSegs <= 2, "a round's counts fill two 16-bit fields");
  Segments seg[kDirs];
  int n, n4;
  int4 cur[kDirs][kSegs];

  // This thread's segment u of the round that starts at segment base: a
  // round's segments u lie over the threads in turn, so that a warp's
  // 16-byte loads are contiguous.
  __device__ __forceinline__ int segment(int base, int u) const {
    return base + u * kGradThreads + threadIdx.x;
  }

  __device__ __forceinline__ void load(int4 (&v)[kDirs][kSegs], int base) {
#pragma unroll
    for (int r = 0; r < kDirs; ++r)
#pragma unroll
      for (int u = 0; u < kSegs; ++u) v[r][u] = seg[r].load(segment(base, u));
  }

  __device__ __forceinline__ void first(const GradDir (&d)[2], int n_src) {
    n = n_src;
#pragma unroll
    for (int r = 0; r < kDirs; ++r) seg[r] = Segments(d[r].w, n);
    n4 = max(seg[0].n4, seg[kDirs - 1].n4);
    load(cur, 0);
  }

  __device__ __forceinline__ void flush(const GradDir& d, int nq,
                                        const int2* queue, unsigned cnt,
                                        const Buckets& bk) {
    __syncthreads();  // the queue's entries are written
    unsigned row[4];
    float gg[4], c[4][3];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int slot = threadIdx.x * 4 + e;
      const bool m = slot < nq;
      const int2 qi = m ? queue[slot] : make_int2(0, 0);
      row[e] = m ? (unsigned)qi.y : kNoRow;
      gg[e] = m ? __fmul_rn(2.0f, __ldg(d.g + qi.x)) : 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        c[e][a] = m ? __ldg(d.pts + 3 * qi.x + a) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (row[e] == kNoRow) continue;
      const int slot = threadIdx.x * 4 + e;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        bk.term[3 * slot + a] =
            __fmul_rn(gg[e], __fsub_rn(d.own[3 * row[e] + a], c[e][a]));
    }
    bucket_add(d.acc, row, cnt, bk);
  }

  __device__ __forceinline__ void rest(const GradDir (&d)[2], unsigned lo,
                                       unsigned cnt, int2* queue,
                                       const Buckets& bk) {
    int nq[kDirs];  // uniform over the block
#pragma unroll
    for (int r = 0; r < kDirs; ++r) nq[r] = 0;
    int parity = 0;
    for (int base = 0; base < n4; base += kSpan) {
      int4 nxt[kDirs][kSegs];
      load(nxt, base + kSpan);
      // the matches of segment u, direction r: bit 4 u + e of hit[r] for
      // source 4 segment(base, u) + e - ph; their counts in 16-bit fields
      // f = r * kSegs + u, scanned together
      unsigned hit[kDirs];
      int packed = 0;
#pragma unroll
      for (int r = 0; r < kDirs; ++r) {
        hit[r] = 0;
#pragma unroll
        for (int u = 0; u < kSegs; ++u) {
          const int v[4] = {cur[r][u].x, cur[r][u].y, cur[r][u].z,
                            cur[r][u].w};
          const int s = segment(base, u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = 4 * s + e - seg[r].ph;
            const unsigned i = (unsigned)v[e] - lo;  // -1, out: >= cnt
            if (q >= 0 && q < n && i < cnt) hit[r] |= 1u << (4 * u + e);
          }
          packed += __popc(hit[r] >> (4 * u) & 15u) << (16 * (r * kSegs + u));
        }
      }
      int total;
      const int pos =
          block_exclusive(packed, bk.wsum + parity * kGradWarps, total);
      parity ^= 1;
#pragma unroll
      for (int r = 0; r < kDirs; ++r) {
        // the round's position of this thread's first match of each
        // segment: the segments u in order, each over the threads
        int first[kSegs], tot = 0;
#pragma unroll
        for (int u = 0; u < kSegs; ++u) {
          const int f = 16 * (r * kSegs + u);
          first[u] = tot + ((pos >> f) & 0xffff);
          tot += (total >> f) & 0xffff;
        }
        int2* qr = queue + r * kBucket;
        for (int done = 0; done < tot;) {  // uniform over the block
          if (nq[r] == kBucket) {
            flush(d[r], nq[r], qr, cnt, bk);
            nq[r] = 0;
          }
          const int take = min(tot - done, kBucket - nq[r]);
#pragma unroll
          for (int u = 0; u < kSegs; ++u) {
            const int v[4] = {cur[r][u].x, cur[r][u].y, cur[r][u].z,
                              cur[r][u].w};
            const int s = segment(base, u);
            int at = first[u];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (!(hit[r] >> (4 * u + e) & 1)) continue;
              if (at >= done && at < done + take)
                qr[nq[r] + at - done] = make_int2(
                    4 * s + e - seg[r].ph, (int)((unsigned)v[e] - lo));
              ++at;
            }
          }
          nq[r] += take;
          done += take;
        }
      }
#pragma unroll
      for (int r = 0; r < kDirs; ++r)
#pragma unroll
        for (int u = 0; u < kSegs; ++u) cur[r][u] = nxt[r][u];
    }
#pragma unroll
    for (int r = 0; r < kDirs; ++r)
      if (nq[r]) flush(d[r], nq[r], queue + r * kBucket, cnt, bk);
  }
};

// A valid block's work once its pointers are set: the first round of the
// walk (kCross directions, 0 to 2) in flight, the own terms of kOwn
// directions (1, or 2 with dy), then the rest of the walk.
template <bool kDiag, int kCross, int kOwn>
__device__ __forceinline__ void grad_block(const GradDir (&cross)[2],
                                           const OwnDir (&own)[2], int n_src,
                                           unsigned lo, int cnt,
                                           int2* queue, const Buckets& bk) {
  constexpr int kWalkDirs = kCross ? kCross : 1;
  using Walk = typename std::conditional<kDiag, DirectWalk<kWalkDirs>,
                                         QueuedWalk<kWalkDirs>>::type;
  Walk walk;
  if (kCross) walk.first(cross, n_src);
  for (int k = threadIdx.x; k < kRowSlots; k += kGradThreads) bk.end[k] = 0;
  own_terms<kOwn>(own, cnt);
  __syncthreads();
  if (kCross) walk.rest(cross, lo, (unsigned)cnt, queue, bk);
}

// Bytes of the grad kernel's dynamic shared memory for chunks of C owned
// points, n_acc accumulators (2 with dy), in either mode: the sort's
// scratch, the accumulators, the staged owned points, a match queue a
// direction (whole shape), then the buckets.
__host__ __device__ __forceinline__ size_t grad_smem(bool diag, int n_acc,
                                                    int C) {
  const size_t sort = (sizeof(RowSort::TempStorage) + 15) / 16 * 16;
  const size_t acc = (size_t)n_acc * grad_stride(C) * sizeof(float);
  const size_t queues = diag ? 0 : (size_t)n_acc * kBucket * sizeof(int2);
  return sort + 2 * acc + queues + 3 * kBucket * sizeof(float) +
         (2 * kBucket + 2 * kRowSlots) * sizeof(unsigned short) +
         2 * kGradWarps * sizeof(int);
}

// One block per (shape b, owned part j, chunk of C owned points); the owned
// rows are dx's (always) and dy's (when dy is not null).  A block of a
// padded part writes zeros and exits.  Otherwise:
//   1. own terms, stored into the shared-memory accumulators (a null
//      cotangent stores 0: nothing needs zeroing);
//   2. cross terms: walk the sources whose witness may lie in part j, all
//      valid points of the shape (whole shape, kDiag false) or part j's own
//      (diagonal, whose witnesses stay in their part), and add each
//      match's term to its owned row through the buckets, in source order;
//   3. write the rows out whole, 16 bytes at a time where aligned.
template <bool kDiag>
__global__ void __launch_bounds__(kGradThreads, kGradBlocksPerSM)
chamfer_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const int* __restrict__ n_parts,
                    const int* __restrict__ w1, const int* __restrict__ w2,
                    const float* __restrict__ g1,
                    const float* __restrict__ g2, float* __restrict__ dx,
                    float* __restrict__ dy, int P, int N, int n_ch, int C) {
  extern __shared__ float4 grad_smem_buf[];
  const int ch = blockIdx.x % n_ch;
  const int j = (blockIdx.x / n_ch) % P;
  const int b = blockIdx.x / (n_ch * P);
  const int c0 = ch * C;
  const int cnt = min(C, N - c0);
  const long long shape = (long long)b * P * N;
  const long long row = shape + (long long)j * N + c0;  // first owned point
  const int n_p = min(max(n_parts[b], 0), P);
  if (j >= n_p) {  // uniform over the block: no thread reaches a barrier
    store_rows(dx + row * 3, nullptr, 3 * cnt);
    if (dy) store_rows(dy + row * 3, nullptr, 3 * cnt);
    return;
  }
  // shared memory, in the order of grad_smem
  const int stride = grad_stride(C);
  const int n_acc = dy ? 2 : 1;
  char* base = reinterpret_cast<char*>(grad_smem_buf);
  Buckets bk;
  bk.sort = reinterpret_cast<RowSort::TempStorage*>(base);
  float* sm = reinterpret_cast<float*>(
      base + (sizeof(RowSort::TempStorage) + 15) / 16 * 16);
  float* ax = sm + phase16(dx + row * 3);
  float* ay = dy ? sm + stride + phase16(dy + row * 3) : nullptr;
  float* tail = sm + n_acc * stride;
  float* sx = tail;
  float* sy = dy ? tail + stride : nullptr;
  tail += n_acc * stride;
  int2* queue = kDiag ? nullptr : reinterpret_cast<int2*>(tail);
  tail += kDiag ? 0 : n_acc * kBucket * 2;
  bk.term = tail;
  bk.key = reinterpret_cast<unsigned short*>(tail + 3 * kBucket);
  bk.src = bk.key + kBucket;
  bk.start = bk.src + kBucket;
  bk.end = bk.start + kRowSlots;
  bk.wsum = reinterpret_cast<int*>(bk.end + kRowSlots);
  const OwnDir own[2] = {
      {ax, sx, x + row * 3, y + shape * 3, w1 + row, g1 ? g1 + row : nullptr},
      {ay, sy, y + row * 3, x + shape * 3, w2 + row,
       g2 ? g2 + row : nullptr}};

  const long long src = shape + (kDiag ? (long long)j * N : 0);
  const int n_src = kDiag ? N : n_p * N;
  const unsigned lo = (unsigned)(j * N + c0);
  // a y source q adds 2 g2_q (x_i - y_q) to dx_i, an x source p adds
  // 2 g1_p (y_i - x_p) to dy_i
  const GradDir to_dx = {w2 + src, g2 ? g2 + src : nullptr, y + src * 3, sx,
                         ax};
  const GradDir to_dy = {w1 + src, g1 ? g1 + src : nullptr, x + src * 3, sy,
                         ay};
  const bool with_dx = g2 != nullptr, with_dy = dy && g1;
  const GradDir cross[2] = {with_dx ? to_dx : to_dy, to_dy};
  if (!dy && with_dx)
    grad_block<kDiag, 1, 1>(cross, own, n_src, lo, cnt, queue, bk);
  else if (!dy)
    grad_block<kDiag, 0, 1>(cross, own, n_src, lo, cnt, queue, bk);
  else if (with_dx && with_dy)
    grad_block<kDiag, 2, 2>(cross, own, n_src, lo, cnt, queue, bk);
  else if (with_dx || with_dy)
    grad_block<kDiag, 1, 2>(cross, own, n_src, lo, cnt, queue, bk);
  else
    grad_block<kDiag, 0, 2>(cross, own, n_src, lo, cnt, queue, bk);
  __syncthreads();
  store_rows(dx + row * 3, ax, 3 * cnt);
  if (dy) store_rows(dy + row * 3, ay, 3 * cnt);
}

// Raises the grad kernels' limit of dynamic shared memory (above 48 KB
// only by this opt-in) to the most a launch asks for, once a device.
cudaError_t allow_grad_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(chamfer_grad_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)grad_smem(true, 2, kGradChunk));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(chamfer_grad_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)grad_smem(false, 2, kGradChunk));
  if (err != cudaSuccess) return err;
  done.fetch_or(bit);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Both directions of the part-structured chamfer (B1 when mode is 0 or 1,
// B3 when mode is 2): one memset of the list count, the prep kernel, one
// main launch (a persistent grid of as many blocks as fit on the card) and
// the unpack.  keys is [2 * B * P * N] scratch; work [1 + B * P * P]
// receives the part-pair list (its count first), which the caller may
// read.  Returns a cudaError_t.
int mpa_chamfer_pair(const float* x, const float* y, const int* n_parts,
                     unsigned long long* keys, int* work, float* d1, float* d2,
                     int* w1, int* w2, int B, int P, int N, int mode,
                     void* stream) {
  if (B == 0 || P == 0 || N == 0) return 0;
  if (mode < kDense || mode > kDiagonal) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long M = (long long)B * P * N;
  // part-pair ids and flat indices into [P * N] are int32
  if ((long long)B * P * P >= (1LL << 31) || (long long)P * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // the grid: as many blocks as fit on the card at once; each reads the
  // list's count and takes its share of the units (split_units)
  int blocks = 0;
  cudaError_t err = resident_pair_blocks<2>(&blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(work, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const size_t bound_bytes = mode == kPruned ? 10 * P * sizeof(float) : 0;
  chamfer_prep_kernel<<<B, kPrepThreads, bound_bytes, s>>>(
      x, y, n_parts, keys, keys + M, work, P, N, mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chamfer_pair_kernel<2><<<blocks, kPairThreads, 0, s>>>(x, y, work, keys,
                                                         keys + M, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long threads = 2 * M;
  chamfer_unpack_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                          kThreads, 0, s>>>(keys, n_parts, x, y, d1, d2, w1,
                                            w2, M, P, N);
  return (int)cudaGetLastError();
}

// Gradient of both directions of the part-structured chamfer (B2 when mode
// is 0, B4 when mode is 2) from the witnesses of mpa_chamfer_pair, in one
// launch.  g1 and g2 ([B * P * N] cotangents of d1 and d2) may each be
// null: it then contributes nothing.  Writes the whole of dx, and of dy
// unless dy is null (nothing is read from either: they need no zeroing);
// padded parts get exact zeros.  Returns a cudaError_t.
int mpa_chamfer_grad(const float* x, const float* y, const int* n_parts,
                     const int* w1, const int* w2, const float* g1,
                     const float* g2, float* dx, float* dy, int B, int P,
                     int N, int mode, void* stream) {
  if (B == 0 || P == 0 || N == 0) return 0;
  if (mode != kDense && mode != kDiagonal) return (int)cudaErrorInvalidValue;
  // owned chunks of C <= kGradChunk points, the last one not empty
  const int pieces = (N + kGradChunk - 1) / kGradChunk;
  const int C = (N + pieces - 1) / pieces;
  const int n_ch = (N + C - 1) / C;
  const long long blocks = (long long)B * P * n_ch;
  // flat indices into [P * N] and the block index are int32
  if ((long long)P * N >= (1LL << 31) || blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool diagonal = mode == kDiagonal;
  const size_t smem = grad_smem(diagonal, dy ? 2 : 1, C);
  const cudaError_t err = allow_grad_smem();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (diagonal)
    chamfer_grad_kernel<true><<<(unsigned)blocks, kGradThreads, smem, s>>>(
        x, y, n_parts, w1, w2, g1, g2, dx, dy, P, N, n_ch, C);
  else
    chamfer_grad_kernel<false><<<(unsigned)blocks, kGradThreads, smem, s>>>(
        x, y, n_parts, w1, w2, g1, g2, dx, dy, P, N, n_ch, C);
  return (int)cudaGetLastError();
}

// B8: one direction of the unfused route's part-structured nearest
// neighbour, every valid point of query among the valid parts of target:
// one memset of the list count, the prep kernel (dense list, key1 only),
// one main launch of chamfer_pair_kernel<1> and the unpack.  keys
// is [B * P * N] scratch, work [1 + B * P * P] scratch.  dist gets the
// clamped distance, idx the JAX numbering (0 and 0 at padded parts).
// Returns a cudaError_t.
int mpa_nn_parts(const float* query, const float* target, const int* n_parts,
                 unsigned long long* keys, int* work, float* dist, int* idx,
                 int B, int P, int N, int npad, void* stream) {
  if (B == 0 || P == 0 || N == 0) return 0;
  // part-pair ids and flat indices into [P * N] are int32, and so is idx
  if ((long long)B * P * P >= (1LL << 31) ||
      (long long)P * std::max(N, npad) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long M = (long long)B * P * N;
  int blocks = 0;
  cudaError_t err = resident_pair_blocks<1>(&blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(work, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  chamfer_prep_kernel<<<B, kPrepThreads, 0, s>>>(
      query, target, n_parts, keys, nullptr, work, P, N, kDense);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chamfer_pair_kernel<1><<<blocks, kPairThreads, 0, s>>>(
      query, target, work, keys, nullptr, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_unpack_kernel<<<(unsigned)((M + kThreads - 1) / kThreads), kThreads, 0,
                     s>>>(keys, n_parts, query, target, dist, idx, M, P, N,
                          npad);
  return (int)cudaGetLastError();
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
