// The PointNet's global max-pool over each cloud's points for Hopper
// (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package pools with
// `jnp.max(x.astype(f32), axis=-2)` (models/modules/encoders.py
// `PointNet`), which XLA fuses into the last layer's output.  Eager
// PyTorch ran `x.float().amax(-2)` over the padded bf16 activations as five
// dense passes: an f32 copy and the max forward; autograd's tie mask, its
// `long` count, the product and the cast of dx backward.  These kernels are
// the same function over x [R clouds, N points, C channels] (C a multiple
// of 8):
//
//   mpa_max_pool_fwd  out[r, c] = max over n of x[r, n, c] in f32 (exact
//                     for bf16) and count[r, c] = how many points attain
//                     it, int32 (max_pool_kernel)
//   mpa_max_pool_bwd  dx[r, n, c] = (g[r, c] / count[r, c]) *
//                     (x[r, n, c] == out[r, c] ? 1 : 0), rounded once to
//                     x's type (max_pool_grad_kernel)
//
// Precision: bit for bit the plain path's.  The backward is autograd's
// formula for `amax` (the gradient split evenly among the ties: the
// quotient by the count, then the product with the mask as 0 or 1, in f32)
// and then the cast of the `.float()`: the IEEE division and the product
// each rounded on their own (the build has no fast math and -fmad=false),
// the cast by `__float2bfloat16`, as PyTorch's own cast on this card.  So a
// negative g gives -0.0 away from the ties, and a padded cloud, whose
// points are all equal, gives g / N at every point.  NaN follows `amax`: a
// NaN anywhere in a column makes its max NaN, which no point equals, so
// its count is 0 and its dx (g / 0) * 0 = NaN.  A max of zero takes the
// sign of the first zero met in the kernel's fixed order (PyTorch's
// depends on its own reduction order); the count and dx do not depend on
// it, since -0 == +0.
//
// What bounds them: bytes.  The forward reads x once (at the flagship,
// 640 clouds x 1000 points x 256 bf16 channels, 327.7 MB: 0.098 ms at
// 3.35 TB/s) and writes [R, C]; the backward reads x once more and writes
// dx (655 MB, 0.196 ms).  The design: one block of 256 threads a cloud
// (640 blocks, all resident at once at five blocks an SM), each thread on 8
// channels of a row through one 16-byte load of bf16, neighbouring threads
// on neighbouring channels, then rows: 32 threads read one 512-byte row at
// C = 256, 16 threads at C = 128.  Each thread keeps four rows of bf16 in
// flight, packed, and a running (max, count) a channel in registers,
// updated by selects; the block's rows meet in shared memory, merged in a
// fixed order, with no atomics: the same bits every run.  The backward
// forms g / count once a channel a thread and streams the rows.  Nothing
// is saved but x and the [R, C] max and count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;      // channels a thread
constexpr int kMinBlocks = 5;  // blocks an SM holds: 640 clouds in one wave
constexpr long long kMaxPoints = 1 << 24;  // f32 counts stay exact
constexpr long long kMaxClouds = 0x7fffffffLL;  // gridDim.x

template <typename T>
struct Vec;

// A thread's 8 channels of a row: `Raw` as loaded (kept packed while the
// loads are in flight: 4 registers for bf16), `unpack` to f32; `kUnroll`
// rows loaded before they are used (the forward's state, a max and a count
// a channel, and the loads fit 48 registers).
template <>
struct Vec<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int kUnroll = 4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& u, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  // each value rounded on its own by PyTorch's cast (`c10::BFloat16`)
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 u;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < kVec; ++i) h[i] = __float2bfloat16(v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Vec<float> {
  struct Raw {
    float4 a, b;
  };
  static constexpr int kUnroll = 2;
  static __device__ __forceinline__ Raw load(const float* p) {
    return {reinterpret_cast<const float4*>(p)[0],
            reinterpret_cast<const float4*>(p)[1]};
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float* v) {
    v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
    v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// How a block covers a cloud: `lanes` threads a row, each on 8 channels
// (channel group g = blockIdx.y * lanes + lane), `rpi` rows at once.
struct Lanes {
  int groups, lanes, rpi, slot, lane, g;
  bool active;

  __device__ explicit Lanes(int C) {
    groups = C / kVec;
    lanes = groups < kThreads ? groups : kThreads;
    rpi = kThreads / lanes;
    slot = threadIdx.x / lanes;
    lane = threadIdx.x % lanes;
    g = blockIdx.y * lanes + lane;
    active = slot < rpi && g < groups;
  }
};

// One more point v of a channel whose running max is m, attained c times:
// `amax`'s rule, a NaN taken and kept (its count is set to 0 at the end,
// `merge`'s caller), with selects and no branch.
__device__ __forceinline__ void take(float v, float& m, int& c) {
  const bool up = v > m || v != v;
  c = up ? 1 : c + (v == m);
  m = up ? v : m;
}

// (m, c) then (mb, cb), the points of b after those of a.
__device__ __forceinline__ void merge(float& m, int& c, float mb, int cb) {
  if (m != m) return;
  if (mb != mb || mb > m) {
    m = mb;
    c = cb;
  } else if (mb == m) {
    c += cb;
  }
}

// out, count [R, C]; one block a cloud (blockIdx.x) and a span of
// lanes * 8 channels (blockIdx.y).
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
max_pool_kernel(const T* __restrict__ x, int N, int C,
                float* __restrict__ out, int* __restrict__ count) {
  __shared__ float s_m[kThreads * kVec];
  __shared__ int s_c[kThreads * kVec];
  const Lanes t(C);
  float m[kVec];
  int c[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    m[i] = -INFINITY;
    c[i] = 0;
  }
  if (t.active) {
    constexpr int U = Vec<T>::kUnroll;
    const T* p = x + (long long)blockIdx.x * N * C + (long long)t.g * kVec;
    int n = t.slot;
    for (; n + (U - 1) * t.rpi < N; n += U * t.rpi) {
      typename Vec<T>::Raw raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        raw[u] = Vec<T>::load(p + (long long)(n + u * t.rpi) * C);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float v[kVec];
        Vec<T>::unpack(raw[u], v);
#pragma unroll
        for (int i = 0; i < kVec; ++i) take(v[i], m[i], c[i]);
      }
    }
    for (; n < N; n += t.rpi) {
      float v[kVec];
      Vec<T>::unpack(Vec<T>::load(p + (long long)n * C), v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) take(v[i], m[i], c[i]);
    }
  }
  // thread (slot, lane) keeps channel j = lane * 8 + i of its slot at
  // slot * width + j
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    s_m[threadIdx.x * kVec + i] = m[i];
    s_c[threadIdx.x * kVec + i] = c[i];
  }
  __syncthreads();
  const int width = t.lanes * kVec;
  for (int j = threadIdx.x; j < width; j += kThreads) {
    const int ch = blockIdx.y * width + j;
    if (ch >= C) continue;
    float mm = s_m[j];
    int cc = s_c[j];
    for (int s = 1; s < t.rpi; ++s) merge(mm, cc, s_m[s * width + j],
                                          s_c[s * width + j]);
    out[(long long)blockIdx.x * C + ch] = mm;
    count[(long long)blockIdx.x * C + ch] = mm != mm ? 0 : cc;
  }
}

// dx [R, N, C] from g, out, count [R, C] and x; the forward's tiling.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
max_pool_grad_kernel(const T* __restrict__ x, const float* __restrict__ out,
                     const int* __restrict__ count,
                     const float* __restrict__ g, int N, int C,
                     T* __restrict__ dx) {
  const Lanes t(C);
  if (!t.active) return;
  const long long rc = (long long)blockIdx.x * C + (long long)t.g * kVec;
  float m[kVec], q[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    m[i] = __ldg(out + rc + i);
    q[i] = __ldg(g + rc + i) / (float)__ldg(count + rc + i);
  }
  const long long base = (long long)blockIdx.x * N * C +
                         (long long)t.g * kVec;
  const T* p = x + base;
  T* d = dx + base;
  constexpr int U = Vec<T>::kUnroll;
  int n = t.slot;
  for (; n + (U - 1) * t.rpi < N; n += U * t.rpi) {
    typename Vec<T>::Raw raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      raw[u] = Vec<T>::load(p + (long long)(n + u * t.rpi) * C);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float v[kVec];
      Vec<T>::unpack(raw[u], v);
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        v[i] = __fmul_rn(q[i], v[i] == m[i] ? 1.0f : 0.0f);
      Vec<T>::store(d + (long long)(n + u * t.rpi) * C, v);
    }
  }
  for (; n < N; n += t.rpi) {
    float v[kVec];
    Vec<T>::unpack(Vec<T>::load(p + (long long)n * C), v);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      v[i] = __fmul_rn(q[i], v[i] == m[i] ? 1.0f : 0.0f);
    Vec<T>::store(d + (long long)n * C, v);
  }
}

bool bad_shape(long long R, long long N, int C) {
  return R <= 0 || R > kMaxClouds || N <= 0 || N > kMaxPoints || C <= 0 ||
         C % kVec != 0;
}

bool misaligned(const void* p) {
  return (unsigned long long)p % 16 != 0;
}

dim3 grid(long long R, int C) {
  const int groups = C / kVec;
  const int lanes = groups < kThreads ? groups : kThreads;
  return dim3((unsigned)R, (groups + lanes - 1) / lanes);
}

template <typename T>
int forward(const void* x, long long R, int N, int C, float* out,
            int* count, cudaStream_t stream) {
  max_pool_kernel<T><<<grid(R, C), kThreads, 0, stream>>>(
      static_cast<const T*>(x), N, C, out, count);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* x, const float* out, const int* count,
             const float* g, long long R, int N, int C, void* dx,
             cudaStream_t stream) {
  max_pool_grad_kernel<T><<<grid(R, C), kThreads, 0, stream>>>(
      static_cast<const T*>(x), out, count, g, N, C, static_cast<T*>(dx));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  x, dx [R, N, C] 16-byte aligned, C a
// multiple of 8, 0 < N <= 2^24; out, g [R, C] f32 and count [R, C] int32.
// Each returns a cudaError_t.

// x -> out (the max of each cloud's channel) and count (its ties).
int mpa_max_pool_fwd(const void* x, long long R, long long N, int C,
                     int dtype, float* out, int* count, void* stream) {
  if (bad_shape(R, N, C) || out == nullptr || count == nullptr)
    return (int)cudaErrorInvalidValue;
  if (misaligned(x)) return (int)cudaErrorMisalignedAddress;
  auto s = (cudaStream_t)stream;
  return dtype == 1
             ? forward<__nv_bfloat16>(x, R, (int)N, C, out, count, s)
             : forward<float>(x, R, (int)N, C, out, count, s);
}

// x, out, count (the forward's) and g, the gradient of out -> dx.
int mpa_max_pool_bwd(const void* x, const float* out, const int* count,
                     const float* g, long long R, long long N, int C,
                     int dtype, void* dx, void* stream) {
  if (bad_shape(R, N, C) || out == nullptr || count == nullptr ||
      g == nullptr)
    return (int)cudaErrorInvalidValue;
  if (misaligned(x) || misaligned(dx))
    return (int)cudaErrorMisalignedAddress;
  auto s = (cudaStream_t)stream;
  return dtype == 1 ? backward<__nv_bfloat16>(x, out, count, g, R, (int)N,
                                              C, dx, s)
                    : backward<float>(x, out, count, g, R, (int)N, C, dx,
                                      s);
}

}  // extern "C"
