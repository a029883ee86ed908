// Masked batch norm for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package leaves its batch norm
// (multi_part_assembly_tpu/models/modules/norm.py `MaskedBatchNorm`) to
// XLA, which fuses it.  Eager PyTorch ran the same formulas as some ten
// passes a direction over the activations, most of them in f32: 24 ms of
// the flagship's 33 ms train step on an H100.  These kernels are the
// train-mode masked batch norm over channels-last rows x [R, C] (C a
// multiple of 8), with the ReLU that follows it where the model has one:
//
//   mpa_bn_moments  the weighted mean and biased variance of each channel
//                   over the rows whose weight is not 0 (bn_moments_kernel,
//                   then bn_moments_final_kernel)
//   mpa_bn_apply    y = bf16(bf16(x * factor) + offset), then max(y, 0)
//                   with the ReLU, over every row (bn_apply_kernel)
//   mpa_bn_backward Σ dy' and Σ dy' x over every row (bn_grad_sums_kernel),
//                   the chain to d weight, d bias, g_mean and g_var
//                   (bn_grad_final_kernel), and dx (bn_grad_apply_kernel)
//
// Weights: one f32 weight a group of `fan` consecutive rows (a cloud of a
// [B, P, N, C] activation is its N rows), or none (every row weighs 1).
// The moments are the plain formulas' (mean = Σ w x / denom, var =
// Σ w (x - mean)^2 / denom, denom = max(Σ w, 1)) for weights that are 0 or
// at least 1 in sum; a group of weight 0 is skipped whole, its rows never
// read, so that padded clouds cost nothing and their values, whatever they
// are, never enter the sums.  In f32: Welford within a thread, Chan's merge
// across threads and blocks, in a fixed order.
//
// Precision: the forward rounds where the plain bf16 arithmetic does, the
// product x * factor to the activations' type, then the sum with offset,
// each on its own (the build has -fmad=false), so y is the plain version's
// bit for bit given the same factor and offset.  The backward is f32 from
// dy to dx, with one rounding of dx: dy' = dy where the forward's output
// was positive (recomputed from x, factor and offset, the same bits; no
// mask is saved), dx = factor dy' + (w / denom) (g_mean + 2 g_var
// (x - mean)).  g_mean and g_var come from d factor = Σ dy' x and
// d offset = Σ dy' over every row through the forward's [C] expressions
// (factor = weight rstd, offset = bias - mean weight rstd, rstd =
// rsqrt(var + eps)), as autograd of those expressions takes them; the
// path from the variance back to the mean is zero in exact arithmetic and
// left out.
//
// What bounds them: bytes.  A forward reads the valid rows once and every
// row once more and writes y; a backward reads dy and x twice and writes
// dx.  At the flagship's five layers (640,000 rows of 64-256 bf16
// channels, 32% of them valid) that is 1.7 GB forward and 3.7 GB backward,
// 1.6 ms at 3.35 TB/s.  The design: a thread owns 8 channels of a row (one
// 16-byte load of bf16), neighbouring threads neighbouring channels and
// then rows, so a block reads contiguous 4 KB per step; each thread loads
// 2 or 4 rows before it uses them; blocks stride over chunks of rows, so
// skipped clouds spread over all blocks.  Reductions run as many blocks as
// the card holds at once, each writing one partial to scratch, and a
// second launch merges the partials in a fixed order: no float atomics,
// the same bits every run on a card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // channels a thread
// rows a thread loads before it uses them: 4 in the forward's apply (72
// registers), 2 where a thread keeps more (the moments' Welford state, the
// backward's dy and x a row)
constexpr int kApplyUnroll = 4;
constexpr int kUnroll = 2;
constexpr int kReduceBlocks = 1024;  // partials of a reduction pass, at most
constexpr int kApplyBlocks = 4096;  // blocks of an elementwise pass, at most
constexpr int kFinalChannels = 32;  // finalize: channels a block
constexpr int kFinalSlices = 32;    // finalize: partial slices a channel
constexpr long long kMaxRows = 1 << 24;  // f32 row counts stay exact

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <>
struct Vec<float> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

// The forward's output before the ReLU: the plain bf16 arithmetic, each
// operation rounded on its own.
template <typename T>
__device__ __forceinline__ float affine(float x, float f, float o) {
  return Vec<T>::round(Vec<T>::round(x * f) + o);
}

// torch.relu's rule: NaN passes, else max(z, 0); its gradient passes
// where the output is not <= 0.
__device__ __forceinline__ float relu(float z) {
  return z != z ? z : fmaxf(z, 0.0f);
}

// How a block covers the rows: `lanes` threads a row, each on 8 channels
// (channel group g = blockIdx.y * lanes + lane), `rpi` rows at once, chunks
// of rpi * U rows strided over the grid.  Rows are at most 2^24, so a row
// index fits an int; element offsets take 64 bits.
template <int U>
struct Tile {
  int groups, lanes, rpi, slot, lane, g, chunks;
  bool active;

  __device__ Tile(int R, int C) {
    groups = C / kVec;
    lanes = groups < kThreads ? groups : kThreads;
    rpi = kThreads / lanes;
    slot = threadIdx.x / lanes;
    lane = threadIdx.x % lanes;
    g = blockIdx.y * lanes + lane;
    active = slot < rpi && g < groups;
    chunks = (R + rpi * U - 1) / (rpi * U);
  }
  __device__ int row(int chunk, int u) const {
    return chunk * rpi * U + u * rpi + slot;
  }
};

// The weight of row r: its group's, groups of `fan` rows.
__device__ __forceinline__ float row_weight(const float* w, int r,
                                            unsigned fan) {
  return w == nullptr ? 1.0f : __ldg(w + (unsigned)r / fan);
}

// (n, mean, m2) += (nb, mb, m2b): Chan's merge of weighted moments.
__device__ __forceinline__ void chan(float& n, float* mean, float* m2,
                                     float nb, const float* mb,
                                     const float* m2b, int k) {
  if (nb == 0.0f) return;
  const float nab = n + nb;
  const float f = nb / nab;
  for (int i = 0; i < k; ++i) {
    const float d = mb[i] - mean[i];
    mean[i] += d * f;
    m2[i] += m2b[i] + d * d * n * f;
  }
  n = nab;
}

__device__ __forceinline__ int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Partial moments of one block: part_n [gridDim.x], part_mean and
// part_m2 [gridDim.x, C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_moments_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  int R, int C, unsigned fan, float* part_n,
                  float* part_mean, float* part_m2) {
  __shared__ float s_n[kThreads];
  __shared__ float s_mean[kThreads * kVec];
  __shared__ float s_m2[kThreads * kVec];
  const Tile<kUnroll> t(R, C);
  float n = 0.0f, mean[kVec], m2[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) mean[i] = m2[i] = 0.0f;
  if (t.active) {
    const T* xg = x + t.g * kVec;
    for (int chunk = blockIdx.x; chunk < t.chunks; chunk += gridDim.x) {
      float v[kUnroll][kVec], wr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = t.row(chunk, u);
        wr[u] = r < R ? row_weight(w, r, fan) : 0.0f;
        if (wr[u] != 0.0f) Vec<T>::load(xg + (long long)r * C, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (wr[u] == 0.0f) continue;
        n += wr[u];
        const float k = wr[u] / n;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float d = v[u][i] - mean[i];
          mean[i] += d * k;
          m2[i] += wr[u] * d * (v[u][i] - mean[i]);
        }
      }
    }
  }
  // merge the block's row slots, slot s + stride into slot s
  const int tid = threadIdx.x;
  s_n[tid] = n;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    s_mean[tid * kVec + i] = mean[i];
    s_m2[tid * kVec + i] = m2[i];
  }
  __syncthreads();
  for (int s = pow2_ceil(t.rpi) / 2; s >= 1; s /= 2) {
    if (t.active && t.slot < s && t.slot + s < t.rpi) {
      const int o = tid + s * t.lanes;
      chan(n, mean, m2, s_n[o], s_mean + o * kVec, s_m2 + o * kVec, kVec);
      s_n[tid] = n;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s_mean[tid * kVec + i] = mean[i];
        s_m2[tid * kVec + i] = m2[i];
      }
    }
    __syncthreads();
  }
  if (t.active && t.slot == 0) {
    const long long base = (long long)blockIdx.x * C + t.g * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      part_mean[base + i] = mean[i];
      part_m2[base + i] = m2[i];
    }
    if (t.g == 0) part_n[blockIdx.x] = n;
  }
}

// The partials merged in a fixed order -> mean, var [C], denom [1]: slice
// s of a channel merges partials s, s + kFinalSlices, ..., then the slices
// merge pairwise.
__global__ void __launch_bounds__(kFinalChannels * kFinalSlices)
bn_moments_final_kernel(const float* __restrict__ part_n,
                        const float* __restrict__ part_mean,
                        const float* __restrict__ part_m2, int parts, int C,
                        float* mean, float* var, float* denom) {
  __shared__ float s_n[kFinalSlices][kFinalChannels];
  __shared__ float s_mean[kFinalSlices][kFinalChannels];
  __shared__ float s_m2[kFinalSlices][kFinalChannels];
  const int c = blockIdx.x * kFinalChannels + threadIdx.x;
  const int s = threadIdx.y;
  float n = 0.0f, m = 0.0f, m2 = 0.0f;
  if (c < C) {
    for (int p = s; p < parts; p += kFinalSlices) {
      const float mb = part_mean[(long long)p * C + c];
      const float m2b = part_m2[(long long)p * C + c];
      chan(n, &m, &m2, part_n[p], &mb, &m2b, 1);
    }
  }
  s_n[s][threadIdx.x] = n;
  s_mean[s][threadIdx.x] = m;
  s_m2[s][threadIdx.x] = m2;
  __syncthreads();
  for (int h = kFinalSlices / 2; h >= 1; h /= 2) {
    if (s < h) {
      chan(n, &m, &m2, s_n[s + h][threadIdx.x], &s_mean[s + h][threadIdx.x],
           &s_m2[s + h][threadIdx.x], 1);
      s_n[s][threadIdx.x] = n;
      s_mean[s][threadIdx.x] = m;
      s_m2[s][threadIdx.x] = m2;
    }
    __syncthreads();
  }
  if (s != 0 || c >= C) return;
  // denom = max(Σ w, 1): below 1 the plain formulas divide by 1
  if (n >= 1.0f) {
    mean[c] = m;
    var[c] = m2 / n;
  } else {
    const float mu = m * n;
    mean[c] = mu;
    var[c] = m2 + n * (m - mu) * (m - mu);
  }
  if (c == 0) denom[0] = n >= 1.0f ? n : 1.0f;
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ factor,
                const T* __restrict__ offset, T* __restrict__ y, int R,
                int C) {
  const Tile<kApplyUnroll> t(R, C);
  if (!t.active) return;
  float f[kVec], o[kVec];
  Vec<T>::load(factor + t.g * kVec, f);
  Vec<T>::load(offset + t.g * kVec, o);
  const T* xg = x + t.g * kVec;
  T* yg = y + t.g * kVec;
  for (int chunk = blockIdx.x; chunk < t.chunks; chunk += gridDim.x) {
    float v[kApplyUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const int r = t.row(chunk, u);
      if (r < R) Vec<T>::load(xg + (long long)r * C, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const int r = t.row(chunk, u);
      if (r >= R) continue;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float z = affine<T>(v[u][i], f[i], o[i]);
        v[u][i] = kRelu ? relu(z) : z;
      }
      Vec<T>::store(yg + (long long)r * C, v[u]);
    }
  }
}

// Partial Σ dy' and Σ dy' x of one block over every row: part_g and
// part_gx [gridDim.x, C].
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_grad_sums_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                    const T* __restrict__ factor,
                    const T* __restrict__ offset, int R, int C,
                    float* part_g, float* part_gx) {
  __shared__ float s_g[kThreads * kVec];
  __shared__ float s_gx[kThreads * kVec];
  const Tile<kUnroll> t(R, C);
  float sg[kVec], sgx[kVec], f[kVec], o[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) sg[i] = sgx[i] = 0.0f;
  if (t.active) {
    if (kRelu) {
      Vec<T>::load(factor + t.g * kVec, f);
      Vec<T>::load(offset + t.g * kVec, o);
    }
    const T* xg = x + t.g * kVec;
    const T* dg = dy + t.g * kVec;
    for (int chunk = blockIdx.x; chunk < t.chunks; chunk += gridDim.x) {
      float v[kUnroll][kVec], d[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = t.row(chunk, u);
        if (r < R) {
          Vec<T>::load(xg + (long long)r * C, v[u]);
          Vec<T>::load(dg + (long long)r * C, d[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t.row(chunk, u) >= R) continue;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          float g = d[u][i];
          if (kRelu && affine<T>(v[u][i], f[i], o[i]) <= 0.0f) g = 0.0f;
          sg[i] += g;
          sgx[i] += g * v[u][i];
        }
      }
    }
  }
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    s_g[tid * kVec + i] = sg[i];
    s_gx[tid * kVec + i] = sgx[i];
  }
  __syncthreads();
  for (int s = pow2_ceil(t.rpi) / 2; s >= 1; s /= 2) {
    if (t.active && t.slot < s && t.slot + s < t.rpi) {
      const int o2 = (tid + s * t.lanes) * kVec;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        sg[i] += s_g[o2 + i];
        sgx[i] += s_gx[o2 + i];
        s_g[tid * kVec + i] = sg[i];
        s_gx[tid * kVec + i] = sgx[i];
      }
    }
    __syncthreads();
  }
  if (t.active && t.slot == 0) {
    const long long base = (long long)blockIdx.x * C + t.g * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      part_g[base + i] = sg[i];
      part_gx[base + i] = sgx[i];
    }
  }
}

// The partial sums added in a fixed order (as the moments' finalize),
// then the chain through the forward's [C] expressions: dweight, dbias
// [C]; coef [2, C] = (g_mean / denom, 2 g_var / denom).
__global__ void __launch_bounds__(kFinalChannels * kFinalSlices)
bn_grad_final_kernel(const float* __restrict__ part_g,
                     const float* __restrict__ part_gx, int parts, int C,
                     const float* __restrict__ weight,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ denom, float* dweight,
                     float* dbias, float* coef) {
  __shared__ float s_g[kFinalSlices][kFinalChannels];
  __shared__ float s_gx[kFinalSlices][kFinalChannels];
  const int c = blockIdx.x * kFinalChannels + threadIdx.x;
  const int s = threadIdx.y;
  float g = 0.0f, gx = 0.0f;
  if (c < C) {
    for (int p = s; p < parts; p += kFinalSlices) {
      g += part_g[(long long)p * C + c];
      gx += part_gx[(long long)p * C + c];
    }
  }
  s_g[s][threadIdx.x] = g;
  s_gx[s][threadIdx.x] = gx;
  __syncthreads();
  for (int h = kFinalSlices / 2; h >= 1; h /= 2) {
    if (s < h) {
      g += s_g[s + h][threadIdx.x];
      gx += s_gx[s + h][threadIdx.x];
      s_g[s][threadIdx.x] = g;
      s_gx[s][threadIdx.x] = gx;
    }
    __syncthreads();
  }
  if (s != 0 || c >= C) return;
  // factor = weight * rstd; offset = bias - (mean * weight) * rstd;
  // g = d offset, gx = d factor
  const float wt = weight[c], mu = mean[c], rs = rstd[c];
  const float g_t1 = -g * rs;  // d (mean * weight)
  dbias[c] = g;
  dweight[c] = gx * rs + g_t1 * mu;
  const float g_rstd = gx * wt - g * (mu * wt);
  const float g_var = g_rstd * -0.5f * (rs * rs * rs);
  const float g_mean = g_t1 * wt;
  coef[c] = g_mean / denom[0];
  coef[C + c] = 2.0f * g_var / denom[0];
}

// dx = factor dy' + w (coef[0] + coef[1] (x - mean)), rounded once.
// Three blocks an SM: at most 85 registers a thread.
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads, 3)
bn_grad_apply_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const T* __restrict__ factor,
                     const T* __restrict__ offset,
                     const float* __restrict__ w, unsigned fan,
                     const float* __restrict__ coef,
                     const float* __restrict__ mean, int R, int C,
                     T* __restrict__ dx) {
  const Tile<kUnroll> t(R, C);
  if (!t.active) return;
  const int c0 = t.g * kVec;
  float f[kVec], o[kVec], ca[kVec], cb[kVec], mu[kVec];
  Vec<T>::load(factor + c0, f);
  if (kRelu) Vec<T>::load(offset + c0, o);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    ca[i] = coef[c0 + i];
    cb[i] = coef[C + c0 + i];
    mu[i] = mean[c0 + i];
  }
  const T* xg = x + c0;
  const T* dg = dy + c0;
  T* og = dx + c0;
  for (int chunk = blockIdx.x; chunk < t.chunks; chunk += gridDim.x) {
    float v[kUnroll][kVec], d[kUnroll][kVec], wr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = t.row(chunk, u);
      wr[u] = 0.0f;
      if (r < R) {
        Vec<T>::load(xg + (long long)r * C, v[u]);
        Vec<T>::load(dg + (long long)r * C, d[u]);
        wr[u] = row_weight(w, r, fan);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = t.row(chunk, u);
      if (r >= R) continue;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float g = d[u][i];
        if (kRelu && affine<T>(v[u][i], f[i], o[i]) <= 0.0f) g = 0.0f;
        float out = f[i] * g;
        if (wr[u] != 0.0f)
          out += wr[u] * (ca[i] + cb[i] * (v[u][i] - mu[i]));
        d[u][i] = out;
      }
      Vec<T>::store(og + (long long)r * C, d[u]);
    }
  }
}

dim3 row_grid(int R, int C, int unroll, int cap) {
  const int groups = C / kVec;
  const int lanes = groups < kThreads ? groups : kThreads;
  const int rows = kThreads / lanes * unroll;
  const int chunks = (R + rows - 1) / rows;
  return dim3(chunks < cap ? chunks : cap, (groups + lanes - 1) / lanes);
}

dim3 final_grid(int C) {
  return dim3((C + kFinalChannels - 1) / kFinalChannels);
}

const dim3 kFinalBlock(kFinalChannels, kFinalSlices);

// A reduction's blocks: as many as the card holds at once (each block
// strides over the row chunks, so a second wave would run on a fraction
// of the SMs), at most kReduceBlocks and the chunks; the partials' order
// is then fixed for a card.
template <typename K>
dim3 reduce_grid(K kernel, int R, int C, int* rc) {
  int dev = 0, sms = 0, per_sm = 0;
  *rc = (int)cudaGetDevice(&dev);
  if (*rc == 0)
    *rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (*rc == 0)
    *rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
  const int resident = sms * per_sm;
  return row_grid(R, C, kUnroll,
                  resident < 1 ? 1
                  : resident < kReduceBlocks ? resident : kReduceBlocks);
}

bool bad_shape(long long R, int C, long long fan) {
  return R <= 0 || R > kMaxRows || C <= 0 || C % kVec != 0 || fan <= 0 ||
         fan > R;
}

bool misaligned(const void* p) {
  return p != nullptr && (unsigned long long)p % 16 != 0;
}

template <typename T>
int moments(const void* x, const float* w, int R, int C, unsigned fan,
            float* scratch, float* mean, float* var, float* denom,
            cudaStream_t stream) {
  int rc = 0;
  const dim3 grid = reduce_grid(bn_moments_kernel<T>, R, C, &rc);
  if (rc != 0) return rc;
  float* part_n = scratch;
  float* part_mean = part_n + grid.x;
  float* part_m2 = part_mean + (long long)grid.x * C;
  bn_moments_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, R, C, fan, part_n, part_mean, part_m2);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  bn_moments_final_kernel<<<final_grid(C), kFinalBlock, 0, stream>>>(
      part_n, part_mean, part_m2, (int)grid.x, C, mean, var, denom);
  return (int)cudaGetLastError();
}

template <typename T>
int apply(const void* x, const void* factor, const void* offset, void* y,
          int R, int C, int relu, cudaStream_t stream) {
  const dim3 grid = row_grid(R, C, kApplyUnroll, kApplyBlocks);
  const T* xt = static_cast<const T*>(x);
  const T* ft = static_cast<const T*>(factor);
  const T* ot = static_cast<const T*>(offset);
  T* yt = static_cast<T*>(y);
  if (relu)
    bn_apply_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, ft, ot, yt,
                                                            R, C);
  else
    bn_apply_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, ft, ot, yt,
                                                             R, C);
  return (int)cudaGetLastError();
}

template <typename T, bool kRelu>
int backward(const T* dy, const T* x, const T* factor, const T* offset,
             const float* w, unsigned fan, const float* weight,
             const float* mean, const float* rstd, const float* denom, int R,
             int C, float* scratch, float* dweight, float* dbias, T* dx,
             cudaStream_t stream) {
  int rc = 0;
  const dim3 grid = reduce_grid(bn_grad_sums_kernel<T, kRelu>, R, C, &rc);
  if (rc != 0) return rc;
  float* part_g = scratch;
  float* part_gx = part_g + (long long)grid.x * C;
  float* coef = part_gx + (long long)grid.x * C;
  bn_grad_sums_kernel<T, kRelu><<<grid, kThreads, 0, stream>>>(
      dy, x, factor, offset, R, C, part_g, part_gx);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  bn_grad_final_kernel<<<final_grid(C), kFinalBlock, 0, stream>>>(
      part_g, part_gx, (int)grid.x, C, weight, mean, rstd, denom, dweight,
      dbias, coef);
  rc = (int)cudaGetLastError();
  if (rc != 0 || dx == nullptr) return rc;
  bn_grad_apply_kernel<T, kRelu>
      <<<row_grid(R, C, kUnroll, kApplyBlocks), kThreads, 0, stream>>>(
          dy, x, factor, offset, w, fan, coef, mean, R, C, dx);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_any(const void* dy, const void* x, const void* factor,
                 const void* offset, const float* w, unsigned fan,
                 const float* weight, const float* mean, const float* rstd,
                 const float* denom, int R, int C, int relu, float* scratch,
                 float* dweight, float* dbias, void* dx,
                 cudaStream_t stream) {
  auto run = relu ? backward<T, true> : backward<T, false>;
  return run(static_cast<const T*>(dy), static_cast<const T*>(x),
             static_cast<const T*>(factor), static_cast<const T*>(offset), w,
             fan, weight, mean, rstd, denom, R, C, scratch, dweight, dbias,
             static_cast<T*>(dx), stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  x, dy, dx, y [R, C] and factor, offset
// [C] 16-byte aligned, C a multiple of 8, 0 < R <= 2^24; w [R / fan] or
// null (every row weighs 1).  Each function but mpa_bn_parts returns a
// cudaError_t.

// Partials of a reduction over [R, C], at most: mpa_bn_moments takes
// parts * (1 + 2 C) floats of scratch, mpa_bn_backward parts * 2 C + 2 C.
int mpa_bn_parts(long long R, int C) {
  if (bad_shape(R, C, 1)) return 0;
  return (int)row_grid((int)R, C, kUnroll, kReduceBlocks).x;
}

// x [R, C] -> mean, var [C], denom [1] (f32).
int mpa_bn_moments(const void* x, const float* w, long long R, int C,
                   long long fan, int dtype, float* scratch, float* mean,
                   float* var, float* denom, void* stream) {
  if (bad_shape(R, C, fan)) return (int)cudaErrorInvalidValue;
  if (misaligned(x)) return (int)cudaErrorMisalignedAddress;
  auto s = (cudaStream_t)stream;
  return dtype == 1
             ? moments<__nv_bfloat16>(x, w, (int)R, C, (unsigned)fan,
                                      scratch, mean, var, denom, s)
             : moments<float>(x, w, (int)R, C, (unsigned)fan, scratch, mean,
                              var, denom, s);
}

// y = x * factor + offset (each rounded), then the ReLU when relu != 0.
int mpa_bn_apply(const void* x, const void* factor, const void* offset,
                 void* y, long long R, int C, int dtype, int relu,
                 void* stream) {
  if (bad_shape(R, C, 1)) return (int)cudaErrorInvalidValue;
  if (misaligned(x) || misaligned(factor) || misaligned(offset) ||
      misaligned(y))
    return (int)cudaErrorMisalignedAddress;
  auto s = (cudaStream_t)stream;
  return dtype == 1
             ? apply<__nv_bfloat16>(x, factor, offset, y, (int)R, C, relu, s)
             : apply<float>(x, factor, offset, y, (int)R, C, relu, s);
}

// dy, x [R, C]; factor, offset [C] (x's type); weight, mean, rstd [C] (f32);
// denom [1] (f32), the moments' -> dweight, dbias [C] (f32) and, when dx
// is not null, dx [R, C].
int mpa_bn_backward(const void* dy, const void* x, const void* factor,
                    const void* offset, const float* w, long long fan,
                    const float* weight, const float* mean, const float* rstd,
                    const float* denom, long long R, int C, int dtype,
                    int relu, float* scratch, float* dweight, float* dbias,
                    void* dx, void* stream) {
  if (bad_shape(R, C, fan) || denom == nullptr)
    return (int)cudaErrorInvalidValue;
  if (misaligned(dy) || misaligned(x) || misaligned(factor) ||
      misaligned(offset) || misaligned(dx))
    return (int)cudaErrorMisalignedAddress;
  auto s = (cudaStream_t)stream;
  return dtype == 1
             ? backward_any<__nv_bfloat16>(dy, x, factor, offset, w,
                                           (unsigned)fan, weight, mean, rstd,
                                           denom, (int)R, C, relu, scratch,
                                           dweight, dbias, dx, s)
             : backward_any<float>(dy, x, factor, offset, w, (unsigned)fan,
                                   weight, mean, rstd, denom, (int)R, C, relu,
                                   scratch, dweight, dbias, dx, s);
}

}  // extern "C"
