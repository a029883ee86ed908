"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles with its own nvcc, all started together, and the
objects link into one shared library with a plain C interface, bound with
ctypes: seconds to build, where a source that includes PyTorch's headers
takes minutes.  The library lands in
`csrc/build/` (listed in .gitignore; `MPA_TORCH_KERNEL_DIR` overrides it),
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is reused.  Nothing here runs at import time: the CPU
tests import every module on a machine with no nvcc.

Every kernel launch goes through `launch`, which checks the launch and
counts it as the tracer's counter `launch.<key>` (utils/tracing.py); every
tensor a kernel reads or writes is checked by `require` first.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

__all__ = ['load_library', 'build_seconds', 'launch', 'require',
           'NVCC_FLAGS']

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_lib = None
_build_seconds = None


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels build only on '
                           'a machine with the CUDA toolkit')
    return path


def _build_dir():
    path = os.environ.get('MPA_TORCH_KERNEL_DIR') or \
        os.path.join(_CSRC, 'build')
    os.makedirs(path, exist_ok=True)
    return path


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mpa_chamfer_pair.restype = i
    lib.mpa_chamfer_pair.argtypes = [p] * 9 + [i, i, i, i, p]
    lib.mpa_chamfer_grad.restype = i
    lib.mpa_chamfer_grad.argtypes = [p] * 9 + [i, i, i, i, p]
    lib.mpa_nn_parts.restype = i
    lib.mpa_nn_parts.argtypes = [p] * 7 + [i, i, i, i, p]
    lib.mpa_nn_dir.restype = i
    lib.mpa_nn_dir.argtypes = [p, p, p, p, i, i, i, p]
    for name in ('mpa_sample_dense', 'mpa_sample_chunked'):
        fn = getattr(lib, name)
        fn.restype = i
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.mpa_lap.restype = i
    lib.mpa_lap.argtypes = [p, p, i, i, p]
    lib.mpa_lap_cost.restype = i
    lib.mpa_lap_cost.argtypes = [p] * 4 + [i, i, i, p]
    q = ctypes.c_longlong
    lib.mpa_bn_parts.restype = i
    lib.mpa_bn_parts.argtypes = [q, i]
    lib.mpa_bn_moments.restype = i
    lib.mpa_bn_moments.argtypes = [p, p, q, i, q, i, p, p, p, p, p]
    lib.mpa_bn_apply.restype = i
    lib.mpa_bn_apply.argtypes = [p, p, p, p, q, i, i, i, p]
    lib.mpa_bn_backward.restype = i
    lib.mpa_bn_backward.argtypes = [p] * 5 + [q] + [p] * 4 + [q, i, i, i] + \
        [p] * 5
    lib.mpa_max_pool_fwd.restype = i
    lib.mpa_max_pool_fwd.argtypes = [p, q, q, i, i, p, p, p]
    lib.mpa_max_pool_bwd.restype = i
    lib.mpa_max_pool_bwd.argtypes = [p] * 4 + [q, q, i, i, p, p]
    lib.mpa_mark.restype = i
    lib.mpa_mark.argtypes = [i, p]
    lib.mpa_mark_count.restype = i
    lib.mpa_mark_count.argtypes = []
    lib.mpa_mark_name.restype = ctypes.c_char_p
    lib.mpa_mark_name.argtypes = [i]
    return lib


def _run(commands):
    """Runs the commands in parallel; raises with every failure's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in commands]
    failed = []
    for c, proc in zip(commands, procs):
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            failed.append(f'{" ".join(c)}\n{err}')
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))


def load_library():
    """The kernels' ctypes library, built from csrc/*.cu on first call
    (the span `setup.build`, utils/tracing.py)."""
    global _lib, _build_seconds
    if _lib is not None:
        return _lib
    from ..utils import tracing  # not at import: utils imports ops
    with _lock:
        if _lib is not None:
            return _lib
        with tracing.span('setup.build', always=True) as timer:
            lib = _bind(ctypes.CDLL(_build()))
        _build_seconds, _lib = timer.seconds, lib
        return _lib


def _build():
    """The library's path, built first when absent."""
    sources = sorted(glob.glob(os.path.join(_CSRC, '*.cu')))
    digest = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, 'rb') as f:
            digest.update(f.read())
    out = os.path.join(_build_dir(),
                       f'libmpa_kernels_{digest.hexdigest()[:12]}.so')
    if not os.path.exists(out):
        # build in a private directory, then rename: concurrent first
        # users never load a half-written library
        with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
            objs = [os.path.join(tmp, os.path.basename(src) + '.o')
                    for src in sources]
            _run([[_nvcc(), *NVCC_FLAGS, '-c', src, '-o', obj]
                  for src, obj in zip(sources, objs)])
            lib = os.path.join(tmp, 'lib.so')
            _run([[_nvcc(), '-shared', *NVCC_FLAGS, '-o', lib, *objs]])
            os.replace(lib, out)
    return out


def build_seconds():
    """Seconds the first load_library() took (None before it ran)."""
    return _build_seconds


def launch(name, key, device, *args):
    """Launch the entry point `name` (`mpa_chamfer_pair`, ...) with `args`
    and the current stream of `device` under its device guard; raise
    RuntimeError on a non-zero return, else count `launch.<key>`."""
    from ..utils import tracing  # not at import: utils imports ops
    lib = load_library()
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args,
                                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA error {rc}')
    tracing.count('launch.' + key)


def require(t, name, dtype, shape, device):
    """Raise ValueError unless `t` is a contiguous `dtype` tensor of
    `shape` on `device` (a device without an index: any CUDA device)."""
    device = torch.device(device)
    if t.device.type != 'cuda' or \
            (device.index is not None and t.device != device):
        where = 'a CUDA tensor' if device.index is None else \
            f'a tensor on {device}'
        raise ValueError(f'{name}: expected {where}, got {t.device}')
    if t.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')
