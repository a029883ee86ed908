// Device-side mesh surface sampling for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas sampling kernels of the JAX package
// (multi_part_assembly_tpu/datasets/device_sampler.py):
//   mpa_sample_dense    <- _sample_kernel (:212), launched by _sample_points
//                          on the dense [n_pieces, 16, Fmax] table
//   mpa_sample_chunked  <- _sample_kernel_chunked (:269), launched by
//                          _sample_points_chunked on the chunked
//                          [total_chunks, 24, Fc] table and its
//                          [3 + Cmax, n_pieces] meta array; the port stores
//                          that table face-major, as the records
//                          [total_chunks * Fc, 24] (one 96-byte record a
//                          face, datasets/device_sampler.py chunk_records),
//                          which the kernel reads
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
// uniforms, its triangle's nine floats and its acceptance (dense: and its
// alias), and write three floats: 64 bytes (chunked) or 68 (dense), no
// arithmetic to speak of.  At the flagship's K <= 640 rows of 1000 points
// that is at most 41 MB, about 12 us at the HBM3 rate, so a launch is
// short and its fixed cost and its chain of dependent loads weigh as much
// as its bytes.  The dense kernel does one thread per point, three
// coalesced uniform reads, then prob and alias, then the nine values of
// the drawn face's triangle: eleven scattered 4-byte reads, each in its
// own 32-byte sector (rows are Fmax floats apart), in two dependent
// rounds.  The chunked kernel reads two sectors of one 96-byte record
// instead (a record is 96-byte aligned, so its three sectors are its own:
// floats 0-7, 8-15, 16-23): a block serves one row (no division on the way
// to the first load), the uniforms are in flight with the slot, then the
// meta pair, then the 16 bytes around prob (floats 8-11, the middle
// sector), then, by frac < prob, floats 0-7 (the first sector) or 12-19
// (the rest of the middle one and the last) as two 16-byte loads, the mix
// and one write.  One sector
// fewer a point outweighs the extra round: the whole record as 16-byte
// loads in one round (three sectors a point) took 1.2 to 1.3x as long with
// the records warm in L2 and 1.04 to 1.06x as long cold
// (scripts/sampler_reads_torch.py, PERF.md).  Cold, the launch is set by
// its chain of four dependent HBM reads and by the records' bytes: a
// piece whose faces are nearly all drawn (everyday, N >= F) moves its
// records whole, 96 bytes a face against the 44 of the dense rows it
// uses, so there the dense kernel is the faster of the two.  The TPU's devices (one-hot MXU matmuls to turn
// per-point gathers into dense work, the sequential chunk axis of the grid
// with its accumulate) have no counterpart: a gather is native here.
// Flat offsets are 64-bit: a chunked table can pass 2^31 floats.
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

// dense rows (datasets/device_sampler.py _ROW_*)
constexpr int kRows = 16;
constexpr int kRowProb = 9;
constexpr int kRowAlias = 10;
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
