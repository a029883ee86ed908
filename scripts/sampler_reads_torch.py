"""How the chunked sampler (kernel B6) should read a face, on one CUDA card.

    python3 scripts/sampler_reads_torch.py [--iters 100]

Builds chip_smoke.py's synthetic everyday set and its chunked tables, then
times three ways to read the same draws, each held bit for bit against
`sample_records_plain` first:
  table       the JAX layout [chunks, 24, Fc], one thread a point: prob,
              then the nine values of one triangle, each 4-byte read in a
              sector of its own, rows 2 KB apart (B6 before its redesign);
  one round   the face's 96-byte record, its first five 16-byte pieces in
              one round of loads, one block a row;
  two rounds  prob's 16 bytes, then the chosen triangle's 32 (the kernel in
              csrc/device_sampler.cu).
The rows are those of chip_smoke.py's sampler phase: one everyday batch's
(K about 200) and K = B*P = 640 drawn over all pieces, N = 1000, the same
uniforms.  Each read is timed with the L2 flushed before every launch and
warm (launches back to back), in the order table, one, two, two, one,
table; the printed time is the mean of its two runs.  The first two reads
are compiled here, into a temporary directory, from a source that includes
csrc/device_sampler.cu, so that all three share its helpers and flags.
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
                        _make_everyday_set)
from multi_part_assembly_tpu_torch.datasets import \
    device_sampler as DS  # noqa: E402
from multi_part_assembly_tpu_torch.ops import cuda_build  # noqa: E402

STUDY_CU = r'''
#include "device_sampler.cu"

namespace {

constexpr int kRowsC = 24, kCRowProb = 9, kCRowATri = 10;

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

int study_sample_table(const float* table, const int* meta, const int* slots,
                       const float* u, float* out, int K, int N, int fc,
                       int n_pieces, void* stream) {
  const long long total = (long long)K * N;
  study_table<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
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
ORDER = ('table', 'one round', 'two rounds', 'two rounds', 'one round',
         'table')


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
    for name in ('study_sample_table', 'study_sample_one_round'):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [p] * 5 + [i] * 4 + [p]
    return lib


def _reads(lib, tables):
    """{read: fn(slots, u) -> points} on the chunked tables."""
    table = tables.table.contiguous()   # the JAX layout, for 'table' only
    records = DS.chunk_records(tables.table)
    meta, fc = tables.n_faces, tables.fmax

    def study(fn, src):
        def run(slots, u):
            out = torch.empty((slots.shape[0], N, 3), device='cuda')
            rc = fn(src.data_ptr(), meta.data_ptr(), slots.data_ptr(),
                    u.data_ptr(), out.data_ptr(), slots.shape[0], N, fc,
                    meta.shape[1], torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f'study kernel: CUDA error {rc}')
            return out
        return run

    return {'table': study(lib.study_sample_table, table),
            'one round': study(lib.study_sample_one_round, records),
            'two rounds': lambda s, u: DS.sample_chunked_cuda(records, meta,
                                                              s, u)}


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
        tables = DS.build_device_tables(ds.all_mesh_paths(), ds.sampler,
                                        'cuda', layout='chunked')
        reads = _reads(_study_library(tmp), tables)
        # the rows and uniforms of chip_smoke.py's everyday sampler checks
        rng = np.random.default_rng(5)
        ds._device_tables = tables
        batch = ds.collate_batch(rng.permutation(len(ds))[:B].tolist())
        rows = [batch['part_slots__packed'],
                rng.integers(0, len(ds.all_mesh_paths()), B * P)]
        for i, slots in enumerate(rows):
            slots = torch.as_tensor(slots, dtype=torch.int32, device='cuda')
            g = torch.Generator(device='cuda').manual_seed(10 + i)
            u = torch.rand((slots.shape[0], 3, N), generator=g, device='cuda')
            want = DS.sample_records_plain(DS.chunk_records(tables.table),
                                           tables.n_faces, slots, u)
            for name, fn in reads.items():
                if not torch.equal(fn(slots, u), want):
                    raise AssertionError(f'{name}: points differ from '
                                         'sample_records_plain')
            times = {name: {'cold': [], 'warm': []} for name in reads}
            for name in ORDER:
                fn = reads[name]
                times[name]['cold'].append(
                    _cold_ms(lambda: fn(slots, u), args.iters))
                times[name]['warm'].append(
                    _cuda_ms(lambda: fn(slots, u), args.iters))
            tag = f'K={slots.shape[0]}'
            summary[tag] = {name: {m: sum(v) / len(v) for m, v in t.items()}
                            for name, t in times.items()}
            for name, t in times.items():
                print(f'{tag} {name}: cold {t["cold"][0]:.4f} / '
                      f'{t["cold"][1]:.4f} ms, warm {t["warm"][0]:.4f} / '
                      f'{t["warm"][1]:.4f} ms (points bitwise equal to the '
                      'plain version)', flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == '__main__':
    main()
