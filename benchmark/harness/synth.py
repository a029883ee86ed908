"""Synthetic Breaking-Bad and PartNet data sets, frozen for the benchmark.

`write_box_obj`, `generate` and `generate_partnet` are a frozen copy of
scripts/make_synthetic_data.py (numpy only), so that the benchmark's data
stays the same whatever later changes to that script.  `build_everyday`
and `build_partnet` make a cell's whole set: one shape a category with its
part count drawn from the traffic's part pool (Breaking-Bad), or the
generator's own uniform part counts (PartNet), then the split lists.
"""

import os

import numpy as np

_CUBE_VERTS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.float64) - 0.5
_CUBE_FACES = [
    (1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2),
    (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8),
]


def write_box_obj(path, scale, offset, rng, detail=1):
    """One irregular box piece: per-axis scale + vertex jitter + offset.

    detail>1 subdivides each face into a detail x detail quad grid
    (~6*detail^2 verts), approximating real Breaking-Bad piece meshes
    (hundreds-thousands of verts) so mesh parse/IO costs are realistic."""
    if detail <= 1:
        v = _CUBE_VERTS * np.asarray(scale)[None]
        v = v + rng.uniform(-0.02, 0.02, v.shape)
        v = v + np.asarray(offset)[None]
        with open(path, 'w') as f:
            for x, y, z in v:
                f.write(f'v {x:.6f} {y:.6f} {z:.6f}\n')
            for face in _CUBE_FACES:
                f.write('f ' + ' '.join(map(str, face)) + '\n')
        return
    verts, faces = [], []
    d = int(detail)
    # six axis-aligned grid faces of the unit cube
    for axis in range(3):
        for side in (0.0, 1.0):
            base = len(verts)
            u, w = [(a, b) for a, b in [((axis + 1) % 3, (axis + 2) % 3)]][0]
            for i in range(d + 1):
                for j in range(d + 1):
                    p = [0.0, 0.0, 0.0]
                    p[axis] = side
                    p[u] = i / d
                    p[w] = j / d
                    verts.append(p)
            for i in range(d):
                for j in range(d):
                    a = base + i * (d + 1) + j
                    b, c, e = a + 1, a + d + 2, a + d + 1
                    faces.append((a, b, c) if side else (a, c, b))
                    faces.append((a, c, e) if side else (a, e, c))
    v = (np.asarray(verts) - 0.5) * np.asarray(scale)[None]
    v = v + rng.uniform(-0.01, 0.01, v.shape)
    v = v + np.asarray(offset)[None]
    with open(path, 'w') as f:
        for x, y, z in v:
            f.write(f'v {x:.6f} {y:.6f} {z:.6f}\n')
        for face in faces:
            f.write('f ' + ' '.join(str(i + 1) for i in face) + '\n')


def generate(out_dir, n_shapes=16, min_parts=2, max_parts=4, seed=0,
             category='Synth', same_val=True, detail=1, categories=None):
    """Build the tree; returns the data_dir to point cfg.data.data_dir at.

    same_val=True lists the identical shapes in the val split (overfit /
    convergence checks); False holds out the last quarter (per category).
    `categories` (list) writes a MULTI-category tree with n_shapes per
    category -- the reference's per-category research workflow
    (train_everyday_categories.sh, test.py --category all) needs the
    split lists to mix categories the data_fn filter can select on
    (reference geometry_data.py:60-63)."""
    rng = np.random.default_rng(seed)
    train, val = [], []
    for cat in (categories or [category]):
        lines = []
        for s in range(n_shapes):
            n_parts = int(rng.integers(min_parts, max_parts + 1))
            frac = os.path.join(out_dir, cat, f'obj{s:03d}', 'fractured_0')
            os.makedirs(frac, exist_ok=True)
            # distinct offsets so translations are learnable and unambiguous
            offsets = rng.uniform(-0.4, 0.4, (n_parts, 3))
            for p in range(n_parts):
                scale = rng.uniform(0.08, 0.3, 3)
                write_box_obj(os.path.join(frac, f'piece_{p}.obj'),
                              scale, offsets[p], rng, detail=detail)
            lines.append(f'{cat}/obj{s:03d}')
        if same_val:
            train += lines
            val += lines
        else:
            k = max(1, len(lines) // 4)
            train += lines[:-k]
            val += lines[-k:]
    with open(os.path.join(out_dir, 'everyday.train.txt'), 'w') as f:
        f.write('\n'.join(train) + '\n')
    with open(os.path.join(out_dir, 'everyday.val.txt'), 'w') as f:
        f.write('\n'.join(val) + '\n')
    return out_dir


def generate_partnet(out_dir, n_shapes=16, min_parts=3, max_parts=20,
                     num_points=1000, seed=0, same_val=True,
                     split_prefix=''):
    """Synthetic PartNet-format tree: ``{split}.npy`` id lists +
    ``shape_data/{id}_level3.npy`` dicts + contact-point side files
    (layout per reference partnet_data.py:29-43, 210-222).

    Parts are boxes; some geometrically-equivalent duplicates are included
    so instance_label / match_ids groups are non-trivial (exercises the
    Hungarian matching path)."""
    rng = np.random.default_rng(seed)
    shape_dir = os.path.join(out_dir, 'shape_data')
    contact_dir = os.path.join(out_dir, 'contact_points')
    os.makedirs(shape_dir, exist_ok=True)
    os.makedirs(contact_dir, exist_ok=True)
    ids = []
    for s in range(n_shapes):
        shape_id = 10000 + s
        n_parts = int(rng.integers(min_parts, max_parts + 1))
        # geo classes: ~half the parts share a class with another part
        n_classes = max(1, n_parts - n_parts // 3)
        geo_ids = np.concatenate([
            np.arange(1, n_classes + 1),
            rng.integers(1, n_classes + 1, n_parts - n_classes),
        ])[:n_parts]
        part_pcs, poses = [], []
        class_shape = {g: rng.uniform(0.05, 0.2, 3) for g in set(geo_ids)}
        for p in range(n_parts):
            scale = class_shape[geo_ids[p]]  # same class = same geometry
            pts = rng.uniform(-0.5, 0.5, (num_points, 3)) * scale[None]
            part_pcs.append(pts.astype(np.float32))
            trans = rng.uniform(-0.4, 0.4, 3)
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            poses.append(np.concatenate([trans, q]).astype(np.float32))
        contacts = np.zeros((n_parts, n_parts, 4), np.float32)
        for p in range(n_parts - 1):  # chain adjacency
            mid = (poses[p][:3] + poses[p + 1][:3]) / 2.0
            contacts[p, p + 1] = np.concatenate([mid, [1.0]])
            contacts[p + 1, p] = np.concatenate([mid, [1.0]])
        data = {
            'part_pcs': np.stack(part_pcs),
            'part_poses': np.stack(poses),
            'part_ids': rng.integers(1, 21, n_parts),
            'geo_part_ids': geo_ids,
            'sym': np.zeros((n_parts, 3), np.float32),
        }
        np.save(os.path.join(shape_dir, f'{shape_id}_level3.npy'), data,
                allow_pickle=True)
        np.save(os.path.join(
            contact_dir,
            f'pairs_with_contact_points_{shape_id}_level3.npy'), contacts,
            allow_pickle=True)
        ids.append(shape_id)
    ids = np.asarray(ids)
    if same_val:
        train, val = ids, ids
    else:
        k = max(1, len(ids) // 4)
        train, val = ids[:-k], ids[-k:]
    np.save(os.path.join(out_dir, f'{split_prefix}train.npy'), train)
    np.save(os.path.join(out_dir, f'{split_prefix}val.npy'), val)
    return out_dir


def build_everyday(root, n_train, n_val, part_pool, detail, seed):
    """`n_train + n_val` shapes, shape i of `part_pool[j]` parts, j drawn
    by a numpy generator seeded `seed`; the first n_train are the train
    split, the rest val.  Returns the part counts."""
    rng = np.random.default_rng(seed)
    counts = rng.choice(np.asarray(part_pool), n_train + n_val)
    cats = []
    for i, n in enumerate(counts):
        cat = f'S{i:05d}'
        generate(root, n_shapes=1, min_parts=int(n), max_parts=int(n),
                 seed=i, category=cat, detail=detail)
        cats.append(f'{cat}/obj000')
    for split, lines in (('train', cats[:n_train]), ('val', cats[n_train:])):
        with open(os.path.join(root, f'everyday.{split}.txt'), 'w') as f:
            f.write('\n'.join(lines) + '\n')
    return [int(c) for c in counts]


def build_partnet(root, n_train, n_val, min_parts, max_parts, num_points,
                  seed, prefix):
    """`n_train + n_val` PartNet shapes from one generator call; the split
    lists `<prefix>train.npy` (the first n_train ids) and
    `<prefix>val.npy`."""
    generate_partnet(root, n_train + n_val, min_parts, max_parts,
                     num_points, seed, same_val=True)
    ids = np.load(os.path.join(root, 'train.npy'))
    os.remove(os.path.join(root, 'train.npy'))
    os.remove(os.path.join(root, 'val.npy'))
    np.save(os.path.join(root, f'{prefix}train.npy'), ids[:n_train])
    np.save(os.path.join(root, f'{prefix}val.npy'), ids[n_train:])
