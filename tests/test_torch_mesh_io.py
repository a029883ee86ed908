"""The port's own mesh sampler against the JAX package's.

The port keeps a copy of the C++ sampler and its ctypes binding
(`multi_part_assembly_tpu_torch/native/`, `datasets/mesh_io.py`).  On the
same meshes and seeds it must give the same points, face counts and device
tables bit for bit, read the same parsed-mesh cache, and load nothing from
under `multi_part_assembly_tpu/`.  Tolerance: exact equality everywhere
(same source, same arithmetic).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from multi_part_assembly_tpu.datasets import mesh_io as JM
from multi_part_assembly_tpu_torch.datasets import mesh_io as TM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_meshes(folder, faces=(5, 37, 300)):
    """Random triangle soups, and a quad mesh that exercises the polygon
    fan and negative indices."""
    paths = []
    for i, nf in enumerate(faces):
        v = np.random.default_rng(i).normal(size=(nf * 3, 3))
        path = os.path.join(folder, f'soup{i}.obj')
        with open(path, 'w') as f:
            f.writelines(f'v {x:.6f} {y:.6f} {z:.6f}\n' for x, y, z in v)
            f.writelines(f'f {3 * j + 1} {3 * j + 2} {3 * j + 3}\n'
                         for j in range(nf))
        paths.append(path)
    path = os.path.join(folder, 'quads.obj')
    with open(path, 'w') as f:
        f.write('v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\nv 1 0 1\n'
                'f 1 2 3 4\nf -6 -5 -1 -2\n')
    paths.append(path)
    return paths


def _samplers(kind):
    port, ref = TM.MeshSampler(), JM.MeshSampler()
    if kind == 'numpy':  # the fallback both take without a toolchain
        port._lib = ref._lib = None
    return port, ref


@pytest.mark.parametrize('kind', ['native', 'numpy'])
def test_points_and_tables_match_jax(tmp_path, monkeypatch, kind):
    monkeypatch.setenv('MPA_MESH_CACHE_DIR', str(tmp_path / 'cache'))
    paths = _write_meshes(str(tmp_path))
    port, ref = _samplers(kind)
    assert port.is_native == ref.is_native == (kind == 'native')
    seeds = np.arange(len(paths), dtype=np.uint64) * 7919 + 3
    np.testing.assert_array_equal(port.sample_batch(paths, 64, seeds),
                                  ref.sample_batch(paths, 64, seeds))
    for path in paths:
        np.testing.assert_array_equal(port.sample(path, 100, 11),
                                      ref.sample(path, 100, 11))
        nf = port.n_faces(path)
        assert nf == ref.n_faces(path)
        for a, b in zip(port.export_tables(path, nf + 5),
                        ref.export_tables(path, nf + 5)):
            np.testing.assert_array_equal(a, b)
    port.close()
    ref.close()


def test_cache_is_shared_with_jax(tmp_path, monkeypatch):
    """A parsed-mesh cache entry written by one package is read by the
    other: same location, same format, same points."""
    monkeypatch.setenv('MPA_MESH_CACHE_DIR', str(tmp_path / 'cache'))
    paths = _write_meshes(str(tmp_path))
    assert TM.mesh_cache_path(paths[0]) == JM.mesh_cache_path(paths[0])
    port = TM.MeshSampler()
    first = [port.sample(p, 50, 5) for p in paths]
    assert all(os.path.exists(TM.mesh_cache_path(p)) for p in paths)
    ref = JM.MeshSampler()
    for p, pts in zip(paths, first):
        np.testing.assert_array_equal(ref.sample(p, 50, 5), pts)
    port.close()
    ref.close()


def test_port_loads_nothing_of_the_jax_package(tmp_path):
    """A fresh process that imports the port and samples a batch has no
    module and no shared library from under multi_part_assembly_tpu/, and
    its sampler library lives in the port's build directory."""
    paths = _write_meshes(str(tmp_path))
    script = textwrap.dedent(f'''
        import json, os, sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import multi_part_assembly_tpu_torch
        from multi_part_assembly_tpu_torch.datasets import GeometryPartDataset
        from multi_part_assembly_tpu_torch.datasets import mesh_io
        s = mesh_io.MeshSampler()
        pts = s.sample_batch({paths!r}, 32, np.arange(4, dtype=np.uint64))
        files = [getattr(m, '__file__', None) or ''
                 for m in list(sys.modules.values())]
        with open('/proc/self/maps') as f:
            maps = [line.split()[-1] for line in f if '/' in line]
        print(json.dumps({{'native': s.is_native, 'lib': mesh_io._LIB_PATH,
                          'shape': list(pts.shape), 'files': files,
                          'modules': sorted(sys.modules),
                          'maps': maps}}))
    ''')
    env = dict(os.environ, MPA_MESH_CACHE_DIR=str(tmp_path / 'cache'))
    out = subprocess.run([sys.executable, '-c', script], capture_output=True,
                         text=True, env=env, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    jax_pkg = os.path.join(ROOT, 'multi_part_assembly_tpu') + os.sep
    port_pkg = os.path.join(ROOT, 'multi_part_assembly_tpu_torch') + os.sep
    assert got['shape'] == [4, 32, 3]
    assert got['native']
    assert got['lib'].startswith(port_pkg) and got['lib'] in got['maps']
    loaded = [f for f in got['files'] + got['maps']
              if os.path.abspath(f).startswith(jax_pkg)]
    assert not loaded, loaded
    assert not any(k == 'jax' or k.startswith(('jax.', 'jaxlib'))
                   for k in got['modules'])
