"""Host-side helpers: mesh and point-cloud files, pickles, part colours.

The port's own copy of multi_part_assembly_tpu/utils/misc.py:17-95 (the
weight-decay mask lives in train/state.py as `decays`).  `save_pc` writes
ASCII PLY directly.
"""

import pickle

import numpy as np

__all__ = ['pickle_load', 'pickle_dump', 'save_pc', 'save_obj', 'apply_pmat',
           'colorize_part_pc', 'to_numpy']


def to_numpy(x):
    """A tensor on any device, or an array-like, as a numpy array."""
    if hasattr(x, 'detach'):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_obj(verts, faces, file):
    """Write a triangle mesh as OBJ."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    with open(file, 'w') as f:
        for x, y, z in verts:
            f.write(f'v {x:.6f} {y:.6f} {z:.6f}\n')
        for tri in faces:
            f.write('f ' + ' '.join(str(int(i) + 1) for i in tri) + '\n')


def apply_pmat(verts, pmat):
    """Apply a homogeneous 4x4 transform to [N, 3] points."""
    verts = np.asarray(verts)
    pmat = np.asarray(pmat)
    return verts @ pmat[:3, :3].T + pmat[:3, 3]


def pickle_load(file, **kwargs):
    """Load a pickle from a path or a file object."""
    if isinstance(file, str):
        with open(file, 'rb') as f:
            return pickle.load(f, **kwargs)
    if hasattr(file, 'read'):
        return pickle.load(file, **kwargs)
    raise TypeError('"file" must be a filename str or a file-object')


def pickle_dump(obj, file=None, **kwargs):
    """Dump a pickle to a path or a file object, or return its bytes."""
    kwargs.setdefault('protocol', 2)
    if file is None:
        return pickle.dumps(obj, **kwargs)
    if isinstance(file, str):
        with open(file, 'wb') as f:
            pickle.dump(obj, f, **kwargs)
    elif hasattr(file, 'write'):
        pickle.dump(obj, file, **kwargs)
    else:
        raise TypeError('"file" must be a filename str or a file-object')


def save_pc(pc, file):
    """Save a point cloud [N, 3] or [N, 6] (xyz, then rgb) as ASCII PLY."""
    pc = np.asarray(pc)
    assert pc.ndim == 2 and pc.shape[1] in (3, 6)
    has_color = pc.shape[1] == 6
    with open(file, 'w') as f:
        f.write('ply\nformat ascii 1.0\n')
        f.write(f'element vertex {pc.shape[0]}\n')
        f.write('property float x\nproperty float y\nproperty float z\n')
        if has_color:
            f.write('property uchar red\nproperty uchar green\n'
                    'property uchar blue\n')
        f.write('end_header\n')
        for row in pc:
            if has_color:
                f.write(f'{row[0]:.6f} {row[1]:.6f} {row[2]:.6f} '
                        f'{int(row[3])} {int(row[4])} {int(row[5])}\n')
            else:
                f.write(f'{row[0]:.6f} {row[1]:.6f} {row[2]:.6f}\n')


def colorize_part_pc(part_pc, colors):
    """One RGB colour a part: [P, N, 3] -> [P, N, 6]."""
    part_pc = np.asarray(part_pc)
    colors = np.asarray(colors)
    P, N, _ = part_pc.shape
    colored_pc = np.zeros((P, N, 6))
    colored_pc[:, :, :3] = part_pc
    colored_pc[:, :, 3:] = colors[:P, None, :3]
    return colored_pc
