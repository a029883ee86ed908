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
// The port stores both tables face-major, as records, which the kernels
// read (datasets/device_sampler.py table_records): dense [n_pieces * Fmax,
// 12], one 48-byte record a face (triangle, prob, alias, one float of
// padding); chunked [total_chunks * Fc, 24], one 96-byte record a face
// (triangle, prob, alias triangle, zero padding).
//
// Both draw N area-weighted surface points for each packed part row k by
// the Walker alias method, with the uniforms u [K, 3, N] given:
//   F = face count of piece slots[k]      (by SLOT, not by row k: the
//                                          round-4 fault of the TPU kernel)
//   rf = u0 * F, f0 = min(floor(rf), F - 1), frac = rf - f0
//   dense:   f = frac < prob[f0] ? f0 : (int)(alias[f0] + 0.5)
//            (the alias is stored as an exact f32 integer; +0.5 before the
//            truncating cast rounds it), then the triangle of face f
//   chunked: prob and both triangles sit in f0's own record (record
//            base[slot] * Fc + f0: a piece's chunks are contiguous): the
//            triangle of f0 when frac < prob, else the inlined triangle of
//            alias(f0)
//   su = sqrt(u1), b1 = su * (1 - u2), b2 = su * u2,
//   p = (a + b1 * e1) + b2 * e2   per coordinate (e1 = b - a, e2 = c - a)
// Out: points [K, N, 3] f32, and optionally the draw of each point as an
// int32 [K, N]: the sampled face (dense), or f0 when the alias test kept it
// and -1 - f0 when it took the alias triangle (chunked: the table holds
// the alias face's triangle, not its index).
//
// What bounds them on the card: bytes.  A point must read its three
// uniforms and write three floats, 24 bytes, and read the table values its
// draw needs (prob, the alias, nine triangle values), each distinct value
// once: no arithmetic to speak of.  At the flagship's K <= 640 rows of 1000
// points that is at most about 40 MB, about 12 us at the HBM3 rate, so a
// launch is short and its chain of dependent loads, and the sectors each
// link touches, weigh as much as its bytes.  Both kernels serve one row a
// block (no division on the way to the first load), load the uniforms
// beside the slot, then the slot's face count (chunked: and first chunk),
// then 16 bytes around prob (floats 8-11, one sector), then only the 32
// bytes of the triangle the draw needs, the mix and one write: two or three
// sectors a point, where the JAX layout puts a face's values in eleven
// sectors Fmax floats apart.  Dense: floats 0-7 of f0 when the draw keeps
// it (float 8 came with prob), floats 0-8 of the alias face otherwise.
// Chunked: by frac < prob, floats 0-7 (the first sector) or 12-19 (the
// rest of the middle one and the last) as two 16-byte loads.  One sector
// fewer a point outweighs the extra round: the whole record in one round
// took longer, cold and warm (scripts/sampler_reads_torch.py, PERF.md).
// Cold, a launch is set by its chain of dependent HBM reads and by the
// records' bytes: a piece whose faces are nearly all drawn (everyday, N >=
// F) moves its records whole, so the dense record holds only what a draw
// needs, 48 bytes (11 floats and one of padding, so that each 16 bytes
// stay aligned): it beat the 64-byte record of the same reads cold and
// warm, and the JAX layout's rows cold (PERF.md).  The TPU's
// devices (one-hot MXU matmuls to turn per-point gathers into dense work,
// the sequential chunk axis of the grid with its accumulate) have no
// counterpart: a gather is native here.  Flat offsets are 64-bit: a table
// can pass 2^31 floats.
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
constexpr unsigned kMaxGridYZ = 65535;  // CUDA's limit on gridDim.y and .z

// dense records (the _ROW_* rows 0-10 of the table and one float of
// padding, one record a face): 12 floats, three float4
constexpr int kDRec4 = 3;
// chunked records (the _CROW_* rows of the table, one record a face):
// 24 floats, six float4
constexpr int kRec4 = 6;
// meta rows (_META_*)
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

// One thread per point n of row k = blockIdx.x.  The chain is slots[k] ->
// the face count -> the 16 bytes of f0's record around prob and alias
// (floats 8-11) -> the drawn face's triangle (f0's floats 0-7, or, after an
// alias draw, face f's floats 0-8) -> one write; the uniforms are loaded
// before the slot, so their latency hides behind it.
__global__ void __launch_bounds__(kThreads)
sample_dense_kernel(const float4* __restrict__ records,
                    const int* __restrict__ n_faces,
                    const int* __restrict__ slots,
                    const float* __restrict__ u, float* __restrict__ out,
                    int* __restrict__ draws, int N, int fmax, int n_pieces) {
  const int k = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  if (n >= N) return;
  const long long p = (long long)k * N + n;
  const float* uk = u + p * 3 - 2 * n;  // u[k, 0, n]
  const float u0 = __ldg(uk), u1 = __ldg(uk + N), u2 = __ldg(uk + 2 * N);
  const int slot = __ldg(slots + k);
  if (slot < 0 || slot >= n_pieces) {
    write_bad(out, draws, p);
    return;
  }
  const Draw d = draw_face(u0, (float)__ldg(n_faces + slot));
  const float4* piece = records + (long long)slot * fmax * kDRec4;
  // round 1: floats 8-11 of f0's record (tri[8], prob, alias, padding)
  const float4 mid = __ldg(piece + (long long)d.f0 * kDRec4 + 2);
  const bool accept = d.frac < mid.y;
  const int f = accept ? d.f0 : (int)__fadd_rn(mid.z, 0.5f);
  // round 2: floats 0-7 of the drawn face, and float 8 after an alias draw
  const float4* rec = piece + (long long)f * kDRec4;
  const float4 a = __ldg(rec), b = __ldg(rec + 1);
  const float t8 =
      accept ? mid.x : __ldg(reinterpret_cast<const float*>(rec + 2));
  const float t[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, t8};
  mix(t, 1, u1, u2, out + p * 3);
  if (draws != nullptr) draws[p] = f;
}

// One thread per point n of row k = blockIdx.x.  The chain is slots[k] ->
// the meta pair (face count, first chunk) -> prob's 16 bytes -> the 32
// bytes of the chosen triangle -> one write; the uniforms are loaded
// before the slot, so their latency hides behind it.
__global__ void __launch_bounds__(kThreads)
sample_chunked_kernel(const float4* __restrict__ records,
                      const int* __restrict__ meta,
                      const int* __restrict__ slots,
                      const float* __restrict__ u, float* __restrict__ out,
                      int* __restrict__ draws, int N, int fc, int n_pieces) {
  const int k = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  if (n >= N) return;
  const long long p = (long long)k * N + n;
  const float* uk = u + p * 3 - 2 * n;  // u[k, 0, n]
  const float u0 = __ldg(uk), u1 = __ldg(uk + N), u2 = __ldg(uk + 2 * N);
  const int slot = __ldg(slots + k);
  if (slot < 0 || slot >= n_pieces) {
    write_bad(out, draws, p);
    return;
  }
  const int nf = __ldg(meta + kMetaNF * n_pieces + slot);
  const int base = __ldg(meta + kMetaBase * n_pieces + slot);
  const Draw d = draw_face(u0, (float)nf);
  const float4* rec = records + ((long long)base * fc + d.f0) * kRec4;
  // round 1: floats 8-11 (tri[8], prob, atri[0..1]); round 2: floats 0-7
  // (accept) or 12-19 (alias)
  const float4 mid = __ldg(rec + 2);
  const bool accept = d.frac < mid.y;
  const float4* half = rec + (accept ? 0 : 3);
  const float4 a = __ldg(half), b = __ldg(half + 1);
  const float lo[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, mid.x};
  const float hi[9] = {mid.z, mid.w, a.x, a.y, a.z, a.w, b.x, b.y, b.z};
  float t[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) t[c] = accept ? lo[c] : hi[c];
  mix(t, 1, u1, u2, out + p * 3);
  if (draws != nullptr) draws[p] = accept ? d.f0 : -1 - d.f0;
}

}  // namespace

extern "C" {

// Records [n_pieces * fmax, 12] (16-byte aligned), n_faces [n_pieces],
// slots [K], uniforms [K, 3, N] -> out [K, N, 3] (draws [K, N] when not
// null).  Returns a cudaError_t.
int mpa_sample_dense(const float* records, const int* n_faces,
                     const int* slots, const float* uniforms, float* out,
                     int* draws, int K, int N, int fmax, int n_pieces,
                     void* stream) {
  if ((long long)K * N == 0) return 0;
  if ((unsigned long long)records % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid(K, (N + kThreads - 1) / kThreads);
  if (grid.y > kMaxGridYZ) return (int)cudaErrorInvalidValue;
  sample_dense_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(records), n_faces, slots, uniforms,
      out, draws, N, fmax, n_pieces);
  return (int)cudaGetLastError();
}

// Records [total_chunks * fc, 24] (16-byte aligned), meta [3 + Cmax,
// n_pieces], slots [K], uniforms [K, 3, N] -> out [K, N, 3] (draws [K, N]
// when not null).  Returns a cudaError_t.
int mpa_sample_chunked(const float* records, const int* meta,
                       const int* slots, const float* uniforms, float* out,
                       int* draws, int K, int N, int fc, int n_pieces,
                       void* stream) {
  if ((long long)K * N == 0) return 0;
  if ((unsigned long long)records % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid(K, (N + kThreads - 1) / kThreads);
  if (grid.y > kMaxGridYZ) return (int)cudaErrorInvalidValue;
  sample_chunked_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(records), meta, slots, uniforms, out,
      draws, N, fc, n_pieces);
  return (int)cudaGetLastError();
}

}  // extern "C"
