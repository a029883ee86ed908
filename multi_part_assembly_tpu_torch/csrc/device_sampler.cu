// Device-side mesh surface sampling for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas sampling kernels of the JAX package
// (multi_part_assembly_tpu/datasets/device_sampler.py):
//   mpa_sample_dense    <- _sample_kernel (:212), launched by _sample_points
//                          on the dense [n_pieces, 16, Fmax] table
//   mpa_sample_chunked  <- _sample_kernel_chunked (:269), launched by
//                          _sample_points_chunked on the chunked
//                          [total_chunks, 24, Fc] table and its
//                          [3 + Cmax, n_pieces] meta array
//
// Both draw N area-weighted surface points for each packed part row k by
// the Walker alias method, with the uniforms u [K, 3, N] given:
//   F = face count of piece slots[k]      (by SLOT, not by row k: the
//                                          round-4 fault of the TPU kernel)
//   rf = u0 * F, f0 = min(floor(rf), F - 1), frac = rf - f0
//   dense:   f = frac < prob[f0] ? f0 : (int)(alias[f0] + 0.5)
//            (the alias is stored as an exact f32 integer; +0.5 before the
//            truncating cast rounds it), then the triangle of face f
//   chunked: prob and both triangles sit in f0's own column (chunk row
//            base[slot] + f0 / Fc, column f0 % Fc): the triangle of f0
//            when frac < prob, else the inlined triangle of alias(f0)
//   su = sqrt(u1), b1 = su * (1 - u2), b2 = su * u2,
//   p = (a + b1 * e1) + b2 * e2   per coordinate (e1 = b - a, e2 = c - a)
// Out: points [K, N, 3] f32, and optionally the draw of each point as an
// int32 [K, N]: the sampled face (dense), or f0 when the alias test kept it
// and -1 - f0 when it took the alias triangle (chunked: the table holds
// the alias face's triangle, not its index).
//
// What bounds them on the card, and what the design does about it: one
// thread per point does three coalesced uniform reads, eleven (dense:
// prob and alias, then the nine values of the drawn face's triangle) or
// ten (chunked: prob, then one of the two triangles in f0's column)
// scattered 4-byte reads into the table, each row Fmax or Fc floats
// apart, and one 12-byte write.  No arithmetic to speak of.  A
// 768-face dense table for about 800 pieces is about 39 MB and the chunked
// one about 79 MB, against the H100's 50 MB L2; at the flagship's K <= 640
// rows of 1000 points (at most 0.64 M points, about 12 M table reads) a
// launch is short enough that its fixed cost is a large part of it.  The
// TPU's devices (one-hot MXU matmuls to turn per-point gathers into dense
// work, the sequential chunk axis of the grid with its accumulate) have no
// counterpart: a gather is native here, and chunking is only a memory
// layout, so the chunked kernel reads f0's chunk directly with no chunk
// loop.  Flat offsets are 64-bit: a chunked table can pass 2^31 floats.
//
// Numerics: every operation is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fsqrt_rn cannot be contracted into an FMA; the library is
// also built with -fmad=false) in the order of the plain PyTorch versions
// in datasets/device_sampler.py, so kernel and plain version agree bit for
// bit, and the dense and chunked kernels agree with each other.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;  // points per block

// dense rows (datasets/device_sampler.py _ROW_*)
constexpr int kRows = 16;
constexpr int kRowProb = 9;
constexpr int kRowAlias = 10;
// chunked rows (_CROW_*) and meta rows (_META_*)
constexpr int kRowsC = 24;
constexpr int kCRowProb = 9;
constexpr int kCRowATri = 10;
constexpr int kMetaNF = 0;
constexpr int kMetaBase = 1;

struct Draw {
  int f0;
  float frac;
};

// The face draw of one point: f0 = min(floor(u0 * F), F - 1).
__device__ __forceinline__ Draw draw_face(float u0, float F) {
  const float rf = __fmul_rn(u0, F);
  const float f0 = fminf(floorf(rf), __fsub_rn(F, 1.0f));
  return {(int)f0, __fsub_rn(rf, f0)};
}

// p = (a + b1 * e1) + b2 * e2 for the triangle t[0..8] (a, e1, e2, each
// xyz), whose values lie `stride` floats apart.
__device__ __forceinline__ void mix(const float* t, long long stride,
                                    float u1, float u2, float* out) {
  const float su = __fsqrt_rn(u1);
  const float b1 = __fmul_rn(su, __fsub_rn(1.0f, u2));
  const float b2 = __fmul_rn(su, u2);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = t[c * stride];
    const float e1 = t[(3 + c) * stride];
    const float e2 = t[(6 + c) * stride];
    out[c] = __fadd_rn(__fadd_rn(a, __fmul_rn(b1, e1)), __fmul_rn(b2, e2));
  }
}

// A slot outside [0, n_pieces) would read another allocation: its points
// come out NaN instead.
__device__ __forceinline__ void write_bad(float* out, int* draws,
                                          long long p) {
  out[p * 3] = out[p * 3 + 1] = out[p * 3 + 2] = CUDART_NAN_F;
  if (draws != nullptr) draws[p] = 0;
}

// one thread per point p = k * N + n of the [K, N] grid
__global__ void __launch_bounds__(kThreads)
sample_dense_kernel(const float* __restrict__ table,
                    const int* __restrict__ n_faces,
                    const int* __restrict__ slots,
                    const float* __restrict__ u, float* __restrict__ out,
                    int* __restrict__ draws, long long total, int N,
                    int fmax, int n_pieces) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const long long k = p / N;
  const long long n = p - k * N;
  const int slot = slots[k];
  if (slot < 0 || slot >= n_pieces) {
    write_bad(out, draws, p);
    return;
  }
  const float* uk = u + k * 3 * N + n;
  const Draw d = draw_face(uk[0], (float)n_faces[slot]);
  const float* t = table + (long long)slot * kRows * fmax;
  const float prob = t[(long long)kRowProb * fmax + d.f0];
  const float alias = t[(long long)kRowAlias * fmax + d.f0];
  const int f = d.frac < prob ? d.f0 : (int)__fadd_rn(alias, 0.5f);
  mix(t + f, fmax, uk[N], uk[2 * N], out + p * 3);
  if (draws != nullptr) draws[p] = f;
}

__global__ void __launch_bounds__(kThreads)
sample_chunked_kernel(const float* __restrict__ table,
                      const int* __restrict__ meta,
                      const int* __restrict__ slots,
                      const float* __restrict__ u, float* __restrict__ out,
                      int* __restrict__ draws, long long total, int N, int fc,
                      int n_pieces) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const long long k = p / N;
  const long long n = p - k * N;
  const int slot = slots[k];
  if (slot < 0 || slot >= n_pieces) {
    write_bad(out, draws, p);
    return;
  }
  const float* uk = u + k * 3 * N + n;
  const Draw d = draw_face(uk[0], (float)meta[kMetaNF * n_pieces + slot]);
  const long long row = (long long)meta[kMetaBase * n_pieces + slot] +
                        d.f0 / fc;
  const float* col = table + row * kRowsC * fc + d.f0 % fc;
  const bool accept = d.frac < col[(long long)kCRowProb * fc];
  mix(accept ? col : col + (long long)kCRowATri * fc, fc, uk[N], uk[2 * N],
      out + p * 3);
  if (draws != nullptr) draws[p] = accept ? d.f0 : -1 - d.f0;
}

unsigned blocks_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Dense table [n_pieces, 16, fmax], n_faces [n_pieces], slots [K],
// uniforms [K, 3, N] -> out [K, N, 3] (draws [K, N] when not null).
// Returns a cudaError_t.
int mpa_sample_dense(const float* table, const int* n_faces, const int* slots,
                     const float* uniforms, float* out, int* draws, int K,
                     int N, int fmax, int n_pieces, void* stream) {
  const long long total = (long long)K * N;
  if (total == 0) return 0;
  sample_dense_kernel<<<blocks_for(total), kThreads, 0,
                        (cudaStream_t)stream>>>(
      table, n_faces, slots, uniforms, out, draws, total, N, fmax, n_pieces);
  return (int)cudaGetLastError();
}

// Chunked table [total_chunks, 24, fc], meta [3 + Cmax, n_pieces], slots
// [K], uniforms [K, 3, N] -> out [K, N, 3] (draws [K, N] when not null).
// Returns a cudaError_t.
int mpa_sample_chunked(const float* table, const int* meta, const int* slots,
                       const float* uniforms, float* out, int* draws, int K,
                       int N, int fc, int n_pieces, void* stream) {
  const long long total = (long long)K * N;
  if (total == 0) return 0;
  sample_chunked_kernel<<<blocks_for(total), kThreads, 0,
                          (cudaStream_t)stream>>>(
      table, meta, slots, uniforms, out, draws, total, N, fc, n_pieces);
  return (int)cudaGetLastError();
}

}  // extern "C"
