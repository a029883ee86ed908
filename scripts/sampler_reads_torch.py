"""How the sampling kernels should read a face, on one CUDA card.

    python3 scripts/sampler_reads_torch.py [--iters 100]

Builds chip_smoke.py's synthetic everyday set and its ragged triangle
soups, their dense and chunked tables, then times several ways to read the
same draws, each held bit for bit against the plain version on the
kernel's inputs first.  Dense (kernel B5):
  table       the JAX layout [n_pieces, 16, Fmax], one thread a point on a
              flat grid: prob and alias, then the nine values of one
              triangle, each 4-byte read in a sector of its own, rows Fmax
              floats apart (B5 before its redesign);
  64-byte one round   records of the table's 16 rows a face (a copy made
              here), f0's first 48 bytes in one round of loads, then, after
              an alias draw, the alias face's triangle; one block a row;
  64-byte two rounds  the same records, the 16 bytes around prob and alias,
              then the drawn face's triangle;
  48-byte one round / two rounds  the same reads on records of rows 0-10
              and one float of padding, the table as the port stores it
              (two rounds: the kernel in csrc/device_sampler.cu).
Chunked (kernel B6):
  table       the JAX layout [chunks, 24, Fc], one thread a point: prob,
              then the nine values of one triangle (B6 before its
              redesign);
  one round   the face's 96-byte record, its first five 16-byte pieces in
              one round of loads, one block a row;
  two rounds  prob's 16 bytes, then the chosen triangle's 32 (the kernel in
              csrc/device_sampler.cu).
The rows are those of chip_smoke.py's sampler phase: one everyday batch's
(K about 200) and K = B*P = 640 drawn over all pieces, N = 1000, on the
everyday set and on the soups, the same uniforms.  Each read is timed with
the L2 flushed before every launch and warm (launches back to back), in
the order of the reads and back; the printed time is the mean of its two
runs, both printed beside it.  The study reads are compiled here, into a
temporary directory, from a source that includes csrc/device_sampler.cu,
so that they share its helpers and flags.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (B, DATA_KEYS, N, P, _cold_ms, _cuda_ms,  # noqa: E402
                        _make_everyday_set, _write_soups)
from multi_part_assembly_tpu_torch.datasets import \
    device_sampler as DS  # noqa: E402
from multi_part_assembly_tpu_torch.ops import cuda_build  # noqa: E402

STUDY_CU = r'''
#include "device_sampler.cu"

namespace {

constexpr int kRowsC = 24, kCRowProb = 9, kCRowATri = 10;
constexpr int kRowsD = 16, kRowProb = 9, kRowAlias = 10;

__global__ void __launch_bounds__(kThreads)
study_table(const float* __restrict__ table, const int* __restrict__ meta,
            const int* __restrict__ slots, const float* __restrict__ u,
            float* __restrict__ out, long long total, int N, int fc,
            int n_pieces) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const long long k = p / N;
  const long long n = p - k * N;
  const int slot = slots[k];
  if (slot < 0 || slot >= n_pieces) {
    write_bad(out, nullptr, p);
    return;
  }
  const float* uk = u + k * 3 * N + n;
  const Draw d = draw_face(uk[0], (float)meta[kMetaNF * n_pieces + slot]);
  const long long row =
      (long long)meta[kMetaBase * n_pieces + slot] + d.f0 / fc;
  const float* col = table + row * kRowsC * fc + d.f0 % fc;
  const bool accept = d.frac < col[(long long)kCRowProb * fc];
  mix(accept ? col : col + (long long)kCRowATri * fc, fc, uk[N], uk[2 * N],
      out + p * 3);
}

__global__ void __launch_bounds__(kThreads)
study_dense_table(const float* __restrict__ table,
                  const int* __restrict__ n_faces,
                  const int* __restrict__ slots, const float* __restrict__ u,
                  float* __restrict__ out, long long total, int N, int fmax,
                  int n_pieces) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const long long k = p / N;
  const long long n = p - k * N;
  const int slot = slots[k];
  if (slot < 0 || slot >= n_pieces) {
    write_bad(out, nullptr, p);
    return;
  }
  const float* uk = u + k * 3 * N + n;
  const Draw d = draw_face(uk[0], (float)n_faces[slot]);
  const float* t = table + (long long)slot * kRowsD * fmax;
  const float prob = t[(long long)kRowProb * fmax + d.f0];
  const float alias = t[(long long)kRowAlias * fmax + d.f0];
  const int f = d.frac < prob ? d.f0 : (int)__fadd_rn(alias, 0.5f);
  mix(t + f, fmax, uk[N], uk[2 * N], out + p * 3);
}

// 64-byte records: the dense table's 16 rows a face, four float4
constexpr int kRec16 = 4;

template <int kRec>
__global__ void __launch_bounds__(kThreads)
study_dense_one_round(const float4* __restrict__ records,
                      const int* __restrict__ n_faces,
                      const int* __restrict__ slots,
                      const float* __restrict__ u, float* __restrict__ out,
                      int N, int fmax, int n_pieces) {
  const int k = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  if (n >= N) return;
  const long long p = (long long)k * N + n;
  const float* uk = u + p * 3 - 2 * n;
  const float u0 = __ldg(uk), u1 = __ldg(uk + N), u2 = __ldg(uk + 2 * N);
  const int slot = __ldg(slots + k);
  if (slot < 0 || slot >= n_pieces) {
    write_bad(out, nullptr, p);
    return;
  }
  const Draw d = draw_face(u0, (float)__ldg(n_faces + slot));
  const float4* piece = records + (long long)slot * fmax * kRec;
  const float4* rec = piece + (long long)d.f0 * kRec;
  float r[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 v = __ldg(rec + i);
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
  if (!(d.frac < r[9])) {
    const float4* alt =
        piece + (long long)(int)__fadd_rn(r[10], 0.5f) * kRec;
    const float4 a = __ldg(alt), b = __ldg(alt + 1);
    const float c = __ldg(reinterpret_cast<const float*>(alt + 2));
    const float v[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c};
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = v[i];
  }
  mix(r, 1, u1, u2, out + p * 3);
}

__global__ void __launch_bounds__(kThreads)
study_dense_two_rounds(const float4* __restrict__ records,
                       const int* __restrict__ n_faces,
                       const int* __restrict__ slots,
                       const float* __restrict__ u, float* __restrict__ out,
                       int N, int fmax, int n_pieces) {
  const int k = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  if (n >= N) return;
  const long long p = (long long)k * N + n;
  const float* uk = u + p * 3 - 2 * n;
  const float u0 = __ldg(uk), u1 = __ldg(uk + N), u2 = __ldg(uk + 2 * N);
  const int slot = __ldg(slots + k);
  if (slot < 0 || slot >= n_pieces) {
    write_bad(out, nullptr, p);
    return;
  }
  const Draw d = draw_face(u0, (float)__ldg(n_faces + slot));
  const float4* piece = records + (long long)slot * fmax * kRec16;
  const float4 mid = __ldg(piece + (long long)d.f0 * kRec16 + 2);
  const bool accept = d.frac < mid.y;
  const int f = accept ? d.f0 : (int)__fadd_rn(mid.z, 0.5f);
  const float4* rec = piece + (long long)f * kRec16;
  const float4 a = __ldg(rec), b = __ldg(rec + 1);
  const float t8 =
      accept ? mid.x : __ldg(reinterpret_cast<const float*>(rec + 2));
  const float t[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, t8};
  mix(t, 1, u1, u2, out + p * 3);
}

__global__ void __launch_bounds__(kThreads)
study_one_round(const float4* __restrict__ records,
                const int* __restrict__ meta, const int* __restrict__ slots,
                const float* __restrict__ u, float* __restrict__ out, int N,
                int fc, int n_pieces) {
  const int k = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  if (n >= N) return;
  const long long p = (long long)k * N + n;
  const float* uk = u + p * 3 - 2 * n;
  const float u0 = __ldg(uk), u1 = __ldg(uk + N), u2 = __ldg(uk + 2 * N);
  const int slot = __ldg(slots + k);
  if (slot < 0 || slot >= n_pieces) {
    write_bad(out, nullptr, p);
    return;
  }
  const int nf = __ldg(meta + kMetaNF * n_pieces + slot);
  const int base = __ldg(meta + kMetaBase * n_pieces + slot);
  const Draw d = draw_face(u0, (float)nf);
  const float4* rec = records + ((long long)base * fc + d.f0) * kRec4;
  float r[20];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float4 v = __ldg(rec + i);
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
  const bool accept = d.frac < r[9];
  float t[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) t[c] = accept ? r[c] : r[10 + c];
  mix(t, 1, u1, u2, out + p * 3);
}

}  // namespace

extern "C" {

int study_dense_table_read(const float* table, const int* n_faces,
                           const int* slots, const float* u, float* out,
                           int K, int N, int fmax, int n_pieces,
                           void* stream) {
  const long long total = (long long)K * N;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  study_dense_table<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, n_faces, slots, u, out, total, N, fmax, n_pieces);
  return (int)cudaGetLastError();
}

int study_dense_one_round_read(const float* records, const int* n_faces,
                               const int* slots, const float* u, float* out,
                               int K, int N, int fmax, int n_pieces,
                               void* stream) {
  const dim3 grid(K, (N + kThreads - 1) / kThreads);
  study_dense_one_round<kRec16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(records), n_faces, slots, u, out, N,
      fmax, n_pieces);
  return (int)cudaGetLastError();
}

int study_dense_one_round48_read(const float* records, const int* n_faces,
                                 const int* slots, const float* u,
                                 float* out, int K, int N, int fmax,
                                 int n_pieces, void* stream) {
  const dim3 grid(K, (N + kThreads - 1) / kThreads);
  study_dense_one_round<kDRec4><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(records), n_faces, slots, u, out, N,
      fmax, n_pieces);
  return (int)cudaGetLastError();
}

int study_dense_two_rounds_read(const float* records, const int* n_faces,
                                const int* slots, const float* u, float* out,
                                int K, int N, int fmax, int n_pieces,
                                void* stream) {
  const dim3 grid(K, (N + kThreads - 1) / kThreads);
  study_dense_two_rounds<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(records), n_faces, slots, u, out, N,
      fmax, n_pieces);
  return (int)cudaGetLastError();
}

int study_sample_table(const float* table, const int* meta, const int* slots,
                       const float* u, float* out, int K, int N, int fc,
                       int n_pieces, void* stream) {
  const long long total = (long long)K * N;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  study_table<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, meta, slots, u, out, total, N, fc, n_pieces);
  return (int)cudaGetLastError();
}

int study_sample_one_round(const float* records, const int* meta,
                           const int* slots, const float* u, float* out,
                           int K, int N, int fc, int n_pieces, void* stream) {
  const dim3 grid(K, (N + kThreads - 1) / kThreads);
  study_one_round<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(records), meta, slots, u, out, N, fc,
      n_pieces);
  return (int)cudaGetLastError();
}

}  // extern "C"
'''
STUDY_FNS = ('study_dense_table_read', 'study_dense_one_round_read',
             'study_dense_one_round48_read',
             'study_dense_two_rounds_read', 'study_sample_table',
             'study_sample_one_round')


def _study_library(tmp):
    src = os.path.join(tmp, 'study.cu')
    lib = os.path.join(tmp, 'libstudy.so')
    with open(src, 'w') as f:
        f.write(STUDY_CU)
    csrc = os.path.join(ROOT, 'multi_part_assembly_tpu_torch', 'csrc')
    cuda_build._run([[cuda_build._nvcc(), '-shared', *cuda_build.NVCC_FLAGS,
                      '-I', csrc, src, '-o', lib]])
    lib = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in STUDY_FNS:
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [p] * 5 + [i] * 4 + [p]
    return lib


def _reads(lib, tables):
    """{layout: {read: fn(slots, u) -> points}} on the tables, the shipped
    kernel last among each layout's reads."""
    def study(fn, src, index, width):
        def run(slots, u):
            out = torch.empty((slots.shape[0], N, 3), device='cuda')
            rc = fn(src.data_ptr(), index.data_ptr(), slots.data_ptr(),
                    u.data_ptr(), out.data_ptr(), slots.shape[0], N, width,
                    index.shape[-1], torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f'study kernel: CUDA error {rc}')
            return out
        return run

    dense, chunked = tables['dense'], tables['chunked']
    table = DS.jax_table(dense.table)
    # the 64-byte records: the JAX table's 16 rows of each face
    rec64 = table.permute(0, 2, 1).contiguous()
    c_rec = DS.table_records(chunked.table)
    nf, meta = dense.n_faces, chunked.n_faces
    return {
        'dense': {
            'table': study(lib.study_dense_table_read, table, nf, dense.fmax),
            '64-byte one round': study(lib.study_dense_one_round_read, rec64,
                                       nf, dense.fmax),
            '64-byte two rounds': study(lib.study_dense_two_rounds_read,
                                        rec64, nf, dense.fmax),
            '48-byte one round': study(lib.study_dense_one_round48_read,
                                       dense.table, nf, dense.fmax),
            '48-byte two rounds': lambda s, u: DS.sample_dense_cuda(
                dense.table, nf, s, u),
        },
        'chunked': {
            'table': study(lib.study_sample_table, chunked.table.contiguous(),
                           meta, chunked.fmax),
            'one round': study(lib.study_sample_one_round, c_rec, meta,
                               chunked.fmax),
            'two rounds': lambda s, u: DS.sample_chunked_cuda(c_rec, meta, s,
                                                              u),
        }}


def _plain(layout, tables):
    t = tables[layout]
    fn = DS.sample_records_plain if layout == 'chunked' else \
        DS.sample_dense_records_plain
    return lambda s, u: fn(DS.table_records(t.table), t.n_faces, s, u)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--iters', type=int, default=100)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: this study runs only on a GPU')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from multi_part_assembly_tpu_torch.datasets import GeometryPartDataset
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ['MPA_MESH_CACHE_DIR'] = os.path.join(tmp, 'mesh_cache')
        data_dir = os.path.join(tmp, 'everyday')
        _make_everyday_set(data_dir)
        ds = GeometryPartDataset(data_dir, 'everyday.train.txt', DATA_KEYS,
                                 num_points=N, max_num_part=P)
        lib = _study_library(tmp)
        # the rows and uniforms of chip_smoke.py's sampler phase
        rng = np.random.default_rng(5)
        sets = {'everyday': ds.all_mesh_paths(),
                'ragged': _write_soups(os.path.join(tmp, 'soups'))}
        batch_rows = None
        for name, paths in sets.items():
            tables = {layout: DS.build_device_tables(paths, ds.sampler, 'cuda',
                                                     layout=layout)
                      for layout in ('dense', 'chunked')}
            reads = _reads(lib, tables)
            if name == 'everyday':
                ds._device_tables = tables['dense']
                order = rng.permutation(len(ds))[:B].tolist()
                batch_rows = ds.collate_batch(order)['part_slots__packed']
                first = batch_rows
            else:
                first = rng.integers(0, len(paths), len(batch_rows))
            for i, slots in enumerate((first,
                                       rng.integers(0, len(paths), B * P))):
                slots = torch.as_tensor(slots, dtype=torch.int32,
                                        device='cuda')
                g = torch.Generator(device='cuda').manual_seed(10 + i)
                u = torch.rand((slots.shape[0], 3, N), generator=g,
                               device='cuda')
                tag = f'{name} K={slots.shape[0]}'
                for layout, fns in reads.items():
                    want = _plain(layout, tables)(slots, u)
                    for read, fn in fns.items():
                        if not torch.equal(fn(slots, u), want):
                            raise AssertionError(
                                f'{layout} {read}: points differ from the '
                                'plain version')
                    names = list(fns)
                    times = {r: {'cold': [], 'warm': []} for r in names}
                    for read in names + names[::-1]:
                        fn = fns[read]
                        times[read]['cold'].append(
                            _cold_ms(lambda: fn(slots, u), args.iters))
                        times[read]['warm'].append(
                            _cuda_ms(lambda: fn(slots, u), args.iters))
                    summary[f'{layout} {tag}'] = {
                        r: {m: sum(v) / len(v) for m, v in t.items()}
                        for r, t in times.items()}
                    for read, t in times.items():
                        c, w = t['cold'], t['warm']
                        print(f'{layout} {tag} {read}: cold '
                              f'{sum(c) / 2:.4f} ({c[0]:.4f} / {c[1]:.4f}) '
                              f'ms, warm {sum(w) / 2:.4f} ({w[0]:.4f} / '
                              f'{w[1]:.4f}) ms (points bitwise equal to the '
                              'plain version)', flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == '__main__':
    main()
