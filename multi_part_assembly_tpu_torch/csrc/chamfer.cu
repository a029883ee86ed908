// Chamfer kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas chamfer kernels of the JAX package
// (multi_part_assembly_tpu/ops/chamfer.py):
//   mpa_chamfer_pair <- _fused_parts_fwd_kernel (:483, whole shape, B1) and
//                       _fused_diag_fwd_kernel (:556, part i vs part i, B3),
//                       both launched by _fused_parts_fwd_pallas (:793);
//                       both directions in one main launch
//   mpa_chamfer_bwd  <- _fused_parts_bwd_kernel (:632) and
//                       _fused_diag_bwd_kernel (:687)
//   mpa_nn_parts     <- _nn_parts_kernel (:284), the unfused route's
//                       part-structured nearest neighbour, one direction
//   mpa_nn_dir       <- _nn_kernel (:110), the nearest neighbour of
//                       [B, N1, 3] in [B, N2, 3] behind chamfer_distance
//
// Layout: part clouds are [B, P, N, 3] f32, C-contiguous; valid parts are a
// prefix of the part axis (n_parts[b] of them).  mpa_chamfer_pair's
// witnesses are flat indices into the other cloud viewed as [P * N] (-1 at
// padded parts); mpa_nn_parts writes the JAX numbering part * Npad + local
// (0 at padded parts), which the unfused backward consumes.  B7 and B8
// share one device-side scan (scan_targets).
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
//   - B7/B8 (scan_targets) give each thread one query point and scan
//     shared-memory tiles of targets, one direction per launch.
//   - The backward is bound by memory and atomics: one gather of the
//     witness, one plain update of the query's own gradient and three
//     atomicAdds into the witness's gradient per point.
//
// Numerics: the distance is (dx*dx + dy*dy) + dz*dz with every operation
// rounded on its own (__fmul_rn / __fadd_rn cannot be contracted into an
// FMA; the build adds -fmad=false), the same expression, in the same order,
// as the plain PyTorch version in ops/chamfer.py.  Distances therefore
// agree bit for bit, and witnesses follow the first-hit rule: among equal
// minima the smallest flat index wins, the rule the TPU kernels keep
// (ops/chamfer.py:530-549) and torch.min's.  B1/B3 get it from the order of
// packed keys, B7/B8 from a strict '<' while walking targets in ascending
// order.

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

// ---------------------------------------------------------------------------
// B1/B3: both directions of the part-structured chamfer in one pass.
//
// A work unit is one (shape b, x-part i, y-part j) pair of the work list
// (j == i in diagonal mode), cut into query chunks of kQChunk points and
// target slices, so that every unit does the same work and no block is
// spent on a padded part.  chamfer_prep_kernel writes the list on the card
// (count first); chamfer_pair_kernel is a persistent grid that walks it;
// chamfer_unpack_kernel turns the packed minima into distances and
// witnesses.
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
constexpr int kGroup = 8;                      // targets per column reduction
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

// One block per shape: sets the shape's keys of its valid parts to kNoKey,
// then appends the shape's part pairs to the work list `work` ([count,
// pair...], pair = (b * P + i) * P + j): every
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
                    unsigned long long* __restrict__ keys, long long M,
                    int* __restrict__ work, int P, int N, int mode) {
  extern __shared__ float bounds[];  // kPruned: c1, c2 [P, 3]; r1, r2,
                                     // ub1, ub2 [P]
  const int b = blockIdx.x;
  const int n_p = min(max(n_parts[b], 0), P);
  const long long off = (long long)b * P * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kPrepThreads / 32;
  for (long long e = threadIdx.x; e < (long long)n_p * N; e += kPrepThreads) {
    keys[off + e] = kNoKey;
    keys[M + off + e] = kNoKey;
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
// registers across them.  Each thread holds kQPT
// consecutive query points of the unit's chunk in registers (flat indices
// qgroup .. qgroup + 7, an aligned group of 8 in its part) and walks the
// target slice, staged in shared memory as float4 points that every lane
// reads at the same address (one broadcast LDS.128 per target for kQPT
// pairs).  Each pair distance serves both directions, with one minimum
// each: the row minimum of every query is taken over a group of kGroup
// targets and kept, with the group, when it beats the best so far (a
// strict '<', so the first group wins a tie); the column minimum of every
// target is taken over the thread's kQPT queries, packed with qgroup, and
// reduced over the warp by reduce_columns and over the block by a
// shared-memory atomicMin.  The columns go to the global keys by atomicMin
// at the end of every unit, the rows when the queries change.  A key thus names an aligned group of 8 candidates, and
// chamfer_unpack_kernel finds the first of them at the key's distance: the
// first hit overall, since the smallest group holding a minimum holds the
// smallest index at that minimum.  The next unit's slice is copied by
// cp.async into the other stage while this one is computed.  Query slots
// past N and target slots past the slice hold NaN: fminf ignores NaN and
// every comparison with it is false, so they never win.
__global__ void __launch_bounds__(kPairThreads, 4)
chamfer_pair_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const int* __restrict__ work,
                    unsigned long long* __restrict__ key1,
                    unsigned long long* __restrict__ key2, int P, int N) {
  __shared__ float4 stage[2][kMaxSlice];
  __shared__ unsigned long long col[kMaxSlice];
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
      col[t] = kNoKey;
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
          cd = q == 0 ? d : fminf(cd, d);
        }
        ck[k] = pack_key(cd, qgroup);
      }
#pragma unroll
      for (int q = 0; q < kQPT; ++q) {
        if (gm[q] < bd[q]) {
          bd[q] = gm[q];
          bw[q] = wbase + g;
        }
      }
      const unsigned long long v = reduce_columns(ck, lane);
      if (lane < kGroup) atomicMin(&col[g + lane], v);
    }
    __syncthreads();

    const long long trow = ((long long)cur.b * P + cur.j) * N + cur.t0;
    for (int t = threadIdx.x; t < cur.tcnt; t += kPairThreads)
      atomicMin(&key2[trow + t], col[t]);
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
    __syncthreads();  // the stage and col are rewritten next
    cur = nxt;
  }
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
  if (i < min(max(n_parts[b], 0), P)) {
    const unsigned long long k = keys[e];
    d = __uint_as_float((unsigned)(k >> 32));
    const int base = (int)(unsigned)(k & 0xffffffffu);
    const int local = base % N;
    const float* self = (second ? y : x) + p * 3;
    const float* other = (second ? x : y) + ((long long)b * P * N + base) * 3;
    w = base;
    for (int c = 0; c < kGroup && local + c < N; ++c) {
      const float* o = other + 3 * c;
      const float dc =
          second ? sqdist(o[0], o[1], o[2], self[0], self[1], self[2])
                 : sqdist(self[0], self[1], self[2], o[0], o[1], o[2]);
      if (dc == d) {
        w = base + c;
        break;
      }
    }
  }
  (second ? d2 : d1)[p] = d;
  (second ? w2 : w1)[p] = w;
}

// Blocks of chamfer_pair_kernel that fit on the current device at once,
// asked once per device.
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
      &per_sm, chamfer_pair_kernel, kPairThreads, 0);
  if (err != cudaSuccess) return err;
  *out = sms * std::max(per_sm, 1);
  if (dev < kMaxDevices) cached[dev] = *out;
  return cudaSuccess;
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
  cudaError_t err = resident_pair_blocks(&blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(work, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const size_t bound_bytes = mode == kPruned ? 10 * P * sizeof(float) : 0;
  chamfer_prep_kernel<<<B, kPrepThreads, bound_bytes, s>>>(
      x, y, n_parts, keys, M, work, P, N, mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chamfer_pair_kernel<<<blocks, kPairThreads, 0, s>>>(x, y, work, keys,
                                                       keys + M, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long threads = 2 * M;
  chamfer_unpack_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                          kThreads, 0, s>>>(keys, n_parts, x, y, d1, d2, w1,
                                            w2, M, P, N);
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
