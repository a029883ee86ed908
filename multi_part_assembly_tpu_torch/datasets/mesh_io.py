"""ctypes binding to the port's native mesh loader/sampler.

The port's own copy of the JAX package's mesh IO: the same C++ sampler
source (`native/mesh_sampler.cpp` of this package), the same cache format
under `MPA_MESH_CACHE_DIR`, the same alias tables and the same points.  The
library builds with `make` at first use into `native/build/` of this
package (listed in .gitignore; `MPA_MESH_LIB_DIR` overrides it), and a
pure-numpy OBJ parser + sampler takes over when no C++ toolchain is
available.  The numpy fallback implements the same area-weighted sampling.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..utils import tracing

__all__ = ['MeshSampler', 'load_obj_numpy', 'sample_surface_numpy',
           'mesh_cache_path', 'f32_to_f16']

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'native')
_BUILD_DIR = os.environ.get('MPA_MESH_LIB_DIR') or \
    os.path.join(_NATIVE_DIR, 'build')
_LIB_PATH = os.path.join(_BUILD_DIR, 'libmpa_mesh.so')
_build_lock = threading.Lock()
_lib = None


def _build_native():
    try:
        subprocess.run(['make', '-C', _NATIVE_DIR,
                        f'BUILD={os.path.abspath(_BUILD_DIR)}'], check=True,
                       capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        # always invoke make: it is an mtime no-op when the .so is
        # current, and it rebuilds a stale .so after source changes
        built = _build_native()
        if not os.path.exists(_LIB_PATH) and not built:
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.mpa_load_mesh.restype = ctypes.c_int64
        lib.mpa_load_mesh.argtypes = [ctypes.c_char_p]
        lib.mpa_free_mesh.argtypes = [ctypes.c_int64]
        lib.mpa_mesh_stats.restype = ctypes.c_int
        lib.mpa_mesh_stats.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.mpa_sample.restype = ctypes.c_int
        lib.mpa_sample.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float)]
        lib.mpa_sample_batch.restype = ctypes.c_int
        lib.mpa_sample_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int]
        lib.mpa_sample_batch_f16.restype = ctypes.c_int
        lib.mpa_sample_batch_f16.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int]
        lib.mpa_f32_to_f16.restype = None
        lib.mpa_f32_to_f16.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int64]
        lib.mpa_load_mesh_cached.restype = ctypes.c_int64
        lib.mpa_load_mesh_cached.argtypes = [ctypes.c_char_p,
                                             ctypes.c_char_p]
        lib.mpa_load_mesh_cached_batch.restype = ctypes.c_int
        lib.mpa_load_mesh_cached_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.mpa_export_tables.restype = ctypes.c_int64
        lib.mpa_export_tables.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def f32_to_f16(src, dst):
    """Convert a C-contiguous f32 array into the f16 array `dst` of the same
    shape, rounding to nearest even: one vectorised native pass, or numpy's
    `astype` (the same rounding, so the same bits) without the library."""
    if src.dtype != np.float32 or dst.dtype != np.float16 or \
            src.shape != dst.shape or not src.flags['C_CONTIGUOUS'] or \
            not dst.flags['C_CONTIGUOUS']:
        raise ValueError(
            f'f32_to_f16: expected C-contiguous f32 -> f16 of one shape, got '
            f'{src.dtype}{src.shape} -> {dst.dtype}{dst.shape}')
    lib = _get_lib()
    if lib is not None:
        lib.mpa_f32_to_f16(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            ctypes.c_int64(src.size))
    else:
        np.copyto(dst, src.astype(np.float16))
    return dst


# ---------------------------------------------------------------------------
# numpy fallback (also the test oracle for the native path)
# ---------------------------------------------------------------------------


def load_obj_numpy(path):
    """Parse an OBJ file -> (verts [V, 3] f32, faces [F, 3] i32)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith('v ') or line.startswith('v\t'):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
            elif line.startswith('f ') or line.startswith('f\t'):
                idx = []
                for tok in line.split()[1:]:
                    v = int(tok.split('/')[0])
                    if v < 0:
                        v = len(verts) + v + 1
                    idx.append(v - 1)
                for k in range(2, len(idx)):  # polygon fan
                    faces.append([idx[0], idx[k - 1], idx[k]])
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def build_alias_table(areas):
    """Walker/Vose alias table over triangle areas -> (prob f32, alias f32).

    Mirrors the native builder (mesh_sampler.cpp build_areas) stack order
    exactly, so the numpy fallback exports bit-matching tables."""
    areas = np.asarray(areas, np.float64)
    nf = len(areas)
    scaled = areas / areas.sum() * nf
    prob = np.ones(nf, np.float64)
    alias = np.arange(nf, dtype=np.int64)
    small = [f for f in range(nf) if scaled[f] < 1.0]
    large = [f for f in range(nf) if scaled[f] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] -= 1.0 - scaled[s]
        (small if scaled[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias.astype(np.float32)


def sample_surface_numpy(verts, faces, n_points, rng):
    """Area-weighted surface sampling (trimesh.sample_surface semantics)."""
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    probs = areas / areas.sum()
    tri = rng.choice(len(faces), size=n_points, p=probs)
    u = rng.random(n_points)
    w = rng.random(n_points)
    su = np.sqrt(u)
    b0, b1, b2 = 1.0 - su, su * (1.0 - w), su * w
    pts = (b0[:, None] * v0[tri] + b1[:, None] * v1[tri] +
           b2[:, None] * v2[tri])
    return pts.astype(np.float32)


def mesh_cache_path(path):
    """Location of a mesh's persistent parsed-mesh cache entry.

    Entries live in a CENTRAL cache directory (`MPA_MESH_CACHE_DIR`,
    default `~/.cache/mpa_mesh`), keyed by the absolute source path's
    hash -- never next to the data: the datasets (like the reference,
    geometry_data.py:56) enumerate fracture dirs with os.listdir, so a
    sidecar in the data tree would be miscounted as a mesh piece.
    Staleness is handled inside the C++ loader ((size, mtime_ns) key).
    `MPA_MESH_CACHE=0` disables the cache entirely."""
    if os.environ.get('MPA_MESH_CACHE', '1') == '0':
        return None
    cache_dir = os.environ.get('MPA_MESH_CACHE_DIR') or \
        os.path.join(os.path.expanduser('~'), '.cache', 'mpa_mesh')
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return None
    import hashlib
    h = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()
    return os.path.join(cache_dir, h + '.mpac')


class MeshSampler:
    """Cached mesh surface sampler (native if available, numpy otherwise).

    Two cache levels on the native path: the in-RAM handle registry
    (valid for this process; evicted by close()) and the on-disk parsed
    -mesh sidecars (persist across processes/epochs; see mesh_cache_path),
    which turn a cold load into one sequential binary read instead of an
    OBJ text parse + alias-table build."""

    def __init__(self, n_threads=None):
        self._lib = _get_lib()
        self._n_threads = n_threads or min(16, os.cpu_count() or 4)
        self._np_cache = {}
        self._handles = {}

    @property
    def is_native(self):
        return self._lib is not None

    def load(self, path):
        """Cache a mesh; returns an opaque key (the path)."""
        if self._lib is not None:
            if path not in self._handles:
                cpath = mesh_cache_path(path)
                if cpath is not None:
                    h = self._lib.mpa_load_mesh_cached(
                        path.encode(), cpath.encode())
                else:
                    h = self._lib.mpa_load_mesh(path.encode())
                if h == 0:
                    raise IOError(f'failed to load mesh {path}')
                self._handles[path] = h
        else:
            if path not in self._np_cache:
                self._np_cache[path] = load_obj_numpy(path)
        return path

    def load_batch(self, paths):
        """Cache many meshes in ONE threaded native call.

        A cold (evicted) registry re-loads O(batch * parts) sidecars per
        batch; a Python loop of per-mesh `load` calls serializes that IO
        on the producer thread (the measured cold-cache bench bottleneck).
        Here the misses ride one `mpa_load_mesh_cached_batch` call that
        threads over meshes with the GIL released.  The numpy sampler and a
        single miss take the sequential path.  The loads of misses are the
        span `data.mesh_load` (utils/tracing.py), kept always."""
        missing = [p for p in dict.fromkeys(paths)
                   if (p not in self._handles if self._lib is not None
                       else p not in self._np_cache)]
        if not missing:
            return
        with tracing.span('data.mesh_load', always=True,
                          pieces=len(missing)):
            self._load_missing(missing)

    def _load_missing(self, missing):
        if self._lib is None or len(missing) == 1:
            for p in missing:
                self.load(p)
            return
        cpaths = [(mesh_cache_path(p) or '') for p in missing]
        pbuf = b'\0'.join(p.encode() for p in missing) + b'\0'
        cbuf = b'\0'.join(c.encode() for c in cpaths) + b'\0'
        handles = np.zeros(len(missing), np.int64)
        rc = self._lib.mpa_load_mesh_cached_batch(
            pbuf, cbuf, len(missing),
            handles.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._n_threads)
        if rc != 0:
            bad = missing[-rc - 1]
            # free the ones that did load before raising
            for p, h in zip(missing, handles):
                if h:
                    self._lib.mpa_free_mesh(int(h))
            raise IOError(f'failed to load mesh {bad}')
        for p, h in zip(missing, handles):
            self._handles[p] = int(h)

    def sample(self, path, n_points, seed):
        """Sample one cached mesh -> [n_points, 3] float32."""
        self.load(path)
        if self._lib is not None:
            out = np.empty((n_points, 3), np.float32)
            rc = self._lib.mpa_sample(
                self._handles[path], n_points, ctypes.c_uint64(seed),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if rc != 0:
                raise IOError(f'sampling failed for {path}')
            return out
        verts, faces = self._np_cache[path]
        return sample_surface_numpy(verts, faces, n_points,
                                    np.random.default_rng(seed))

    def sample_batch(self, paths, n_points, seeds, out=None):
        """Sample many cached meshes -> [len(paths), n_points, 3], mesh i
        with seeds[i].

        `out`, when given, is the C-contiguous [len(paths), n_points, 3]
        array of f32 or f16 to write into (default: a new f32 array).  An
        f16 `out` takes the sampler's half-float store: the same f32 sample
        stream, rounded to nearest even on store, so the rows are exactly
        f16 of the f32 rows.  The native path is multithreaded in C++ with
        the GIL released."""
        n = len(paths)
        if out is None:
            out = np.empty((n, n_points, 3), np.float32)
        if not (out.flags['C_CONTIGUOUS'] and out.shape == (n, n_points, 3)
                and out.dtype in (np.float32, np.float16)):
            raise ValueError(
                f'sample_batch out mismatch: shape={out.shape} vs '
                f'({n}, {n_points}, 3), dtype={out.dtype}, '
                f"contiguous={out.flags['C_CONTIGUOUS']}")
        if self._lib is not None:
            self.load_batch(paths)  # threaded cached (re)load of misses
            handles = np.asarray([self._handles[p] for p in paths],
                                 np.int64)
            seeds = np.asarray(seeds, np.uint64)
            if out.dtype == np.float16:
                fn, ptr = self._lib.mpa_sample_batch_f16, ctypes.c_uint16
            else:
                fn, ptr = self._lib.mpa_sample_batch, ctypes.c_float
            rc = fn(handles.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    n, n_points,
                    seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                    out.ctypes.data_as(ctypes.POINTER(ptr)),
                    self._n_threads)
            if rc != 0:
                raise IOError(f'batch sampling failed (rc={rc})')
            return out
        for i, (p, s) in enumerate(zip(paths, seeds)):
            out[i] = self.sample(p, n_points, int(s))  # numpy rounds to f16
        return out

    def n_faces(self, path):
        """Triangle count of a cached mesh (loads it if needed)."""
        self.load(path)
        if self._lib is not None:
            nv = ctypes.c_int64()
            nf = ctypes.c_int64()
            rc = self._lib.mpa_mesh_stats(
                self._handles[path], ctypes.byref(nv), ctypes.byref(nf))
            if rc != 0:
                raise IOError(f'mesh stats failed for {path}')
            return int(nf.value)
        return int(len(self._np_cache[path][1]))

    def export_tables(self, path, f_pad):
        """Device-sampler tables for one cached mesh (see device_sampler.py).

        Returns (tri9 [9, f_pad] f32 component-major (a, b-a, c-a),
        prob [f_pad] f32 alias acceptance, alias [f_pad] f32-encoded alias
        face indices, n_faces).  Padding rows: tri 0, prob 1.0, alias self
        -- an f0 drawn as floor(u * n_faces) never lands there."""
        self.load(path)
        tri9 = np.empty((9, f_pad), np.float32)
        prob = np.empty((f_pad, ), np.float32)
        alias = np.empty((f_pad, ), np.float32)
        if self._lib is not None:
            nf = self._lib.mpa_export_tables(
                self._handles[path], ctypes.c_int64(f_pad),
                tri9.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                alias.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if nf < 0:
                raise ValueError(
                    f'export_tables failed for {path} (f_pad={f_pad})')
            return tri9, prob, alias, int(nf)
        verts, faces = self._np_cache.get(path) or load_obj_numpy(path)
        nf = len(faces)
        if f_pad < nf:
            raise ValueError(f'export_tables: f_pad {f_pad} < n_faces {nf}')
        v0, v1, v2 = (verts[faces[:, k]] for k in range(3))
        tri9[:] = 0.0
        tri9[0:3, :nf] = v0.T
        tri9[3:6, :nf] = (v1 - v0).T
        tri9[6:9, :nf] = (v2 - v0).T
        areas = 0.5 * np.linalg.norm(
            np.cross((v1 - v0).astype(np.float64),
                     (v2 - v0).astype(np.float64)), axis=-1)
        p, a = build_alias_table(areas)
        prob[:nf] = p
        prob[nf:] = 1.0
        alias[:nf] = a
        alias[nf:] = np.arange(nf, f_pad, dtype=np.float32)
        return tri9, prob, alias, nf

    def close(self):
        if self._lib is not None:
            for h in self._handles.values():
                self._lib.mpa_free_mesh(h)
            self._handles.clear()
        self._np_cache.clear()
