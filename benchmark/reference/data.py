"""The batches of a training run, worked out again from the raw data files.

Plain numpy and PyTorch.  Nothing here imports the program: the split
lists, the epoch order, the mesh parse, the area-weighted alias tables,
the two samplers' draws, the PartNet labels and the augmentation are
written out from what the program documents, so that the reference sees
the same points as the timed path without taking any of them from it.

Draws that the program makes with PyTorch generators (the slot wire's
uniforms, the augmentation's rotations) are made here with generators of
the same kind, seeded the same way, in the same order and shapes.  The
host wire's draws come from a PCG32 stream a mesh, replayed in numpy.
"""

import os

import numpy as np
import torch

MESH_EXTS = ('.obj', '.off', '.ply', '.stl')
EPOCH_SEED_MUL = 1000003          # a geometric epoch's sampling seed step
SAMPLER_KEY = 0x5e1ec7ab          # the slot wire's stream separator
PCG_MUL = 6364136223846793005
PCG_SEQ = 0xda3e39cb94b95bdb
U64 = np.uint64


# ---------------------------------------------------------------------------
# split lists and the epoch order
# ---------------------------------------------------------------------------


def mesh_names(folder):
    return sorted(f for f in os.listdir(folder)
                  if f.lower().endswith(MESH_EXTS))


def geometry_items(data_dir, data_fn, min_parts, max_parts):
    """[(item dir relative to data_dir, [mesh paths])] of a Breaking-Bad
    split: every fracture directory of the listed objects whose piece
    count lies in [min_parts, max_parts]."""
    with open(os.path.join(data_dir, data_fn)) as f:
        objects = [line.strip() for line in f.readlines()]
    items = []
    for obj in objects:
        obj_dir = os.path.join(data_dir, obj)
        if not os.path.isdir(obj_dir):
            continue
        for frac in sorted(os.listdir(obj_dir)):
            if 'fractured' not in frac and 'mode' not in frac:
                continue
            folder = os.path.join(obj_dir, frac)
            names = mesh_names(folder)
            if min_parts <= len(names) <= max_parts:
                items.append((os.path.join(obj, frac),
                              [os.path.join(folder, n) for n in names]))
    return items


def partnet_items(data_dir, data_fn, min_parts, max_parts, level=3):
    """[(shape id, shape file)] of a PartNet split, in part-count range."""
    items = []
    for sid in np.load(os.path.join(data_dir, data_fn)):
        path = os.path.join(data_dir, 'shape_data',
                            f'{sid}_level{level}.npy')
        n = np.load(path, allow_pickle=True).item()['part_pcs'].shape[0]
        if min_parts <= n <= max_parts:
            items.append((int(sid), path))
    return items


def epoch_batches(n_items, batch_size, seed, epoch):
    """The item indices of each batch of an epoch: a numpy generator seeded
    `seed + epoch` shuffles arange(n) in place; the last partial batch is
    dropped."""
    order = np.arange(n_items)
    np.random.default_rng(seed + epoch).shuffle(order)
    return [order[i * batch_size:(i + 1) * batch_size]
            for i in range(n_items // batch_size)]


# ---------------------------------------------------------------------------
# meshes: parse, areas, alias table
# ---------------------------------------------------------------------------


def parse_obj(path):
    """(verts [V, 3] f32, faces [F, 3] int64) of an OBJ file, polygons
    fanned from their first vertex."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith(('v ', 'v\t')):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith(('f ', 'f\t')):
                idx = []
                for tok in line.split()[1:]:
                    v = int(tok.split('/')[0])
                    idx.append(v - 1 if v > 0 else len(verts) + v)
                for k in range(2, len(idx)):
                    faces.append([idx[0], idx[k - 1], idx[k]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


class Mesh:
    """A piece ready to sample: `tri` [F, 9] f32 (a, b - a, c - a), the
    alias acceptance `prob` [F] f64 and the alias face `alias` [F]."""

    def __init__(self, path):
        verts, faces = parse_obj(path)
        a, b, c = (verts[faces[:, k]] for k in range(3))
        e1, e2 = b - a, c - a  # f32 differences
        self.tri = np.concatenate([a, e1, e2], axis=1)
        # areas in f64 from the f32 edges, accumulated in face order
        cross = np.cross(e1.astype(np.float64), e2.astype(np.float64))
        cum = np.cumsum(0.5 * np.sqrt((cross * cross).sum(1)))
        self.prob, self.alias = _alias_table(cum)
        self.n_faces = len(faces)


def _alias_table(cum):
    """Walker/Vose alias table from cumulative areas: buckets scaled to a
    mean of 1, the small and large stacks popped from their ends."""
    nf = len(cum)
    area = np.diff(np.concatenate([[0.0], cum]))
    scaled = (area / cum[-1] * float(nf)).tolist()
    prob = [1.0] * nf
    alias = list(range(nf))
    small = [f for f in range(nf) if scaled[f] < 1.0]
    large = [f for f in range(nf) if scaled[f] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] -= 1.0 - scaled[s]
        (small if scaled[l] < 1.0 else large).append(l)
    return np.asarray(prob, np.float64), np.asarray(alias, np.int64)


class MeshCache:
    def __init__(self):
        self._meshes = {}

    def __call__(self, path):
        if path not in self._meshes:
            self._meshes[path] = Mesh(path)
        return self._meshes[path]


# ---------------------------------------------------------------------------
# the two geometric samplers
# ---------------------------------------------------------------------------


def slot_wire_points(meshes, batch_seed, n_points, device):
    """[K, n_points, 3] f32 of the slot wire: uniforms [K, 3, N] drawn by
    `torch.rand` from a generator seeded (SAMPLER_KEY << 32) | seed on
    `device`; a face f0 = min(floor(u0 F), F - 1) kept where the remainder
    is under its acceptance, else its alias; the point a + b1 e1 + b2 e2
    with b1 = s (1 - u2), b2 = s u2, s = sqrt(u1) rounded once to f32."""
    gen = torch.Generator(device=device)
    gen.manual_seed((SAMPLER_KEY << 32) | (int(batch_seed) & 0xffffffff))
    u = torch.rand((len(meshes), 3, n_points), generator=gen, device=device)
    out = []
    for k, mesh in enumerate(meshes):
        tri = torch.from_numpy(mesh.tri).to(device)
        prob = torch.from_numpy(mesh.prob.astype(np.float32)).to(device)
        alias = torch.from_numpy(mesh.alias).to(device)
        rf = u[k, 0] * float(mesh.n_faces)
        f0 = torch.clamp(torch.floor(rf), max=mesh.n_faces - 1)
        keep = (rf - f0) < prob[f0.long()]
        face = torch.where(keep, f0.long(), alias[f0.long()])
        t = tri[face]
        s = torch.sqrt(u[k, 1].double()).float()
        b1 = (s * (1.0 - u[k, 2]))[:, None]
        b2 = (s * u[k, 2])[:, None]
        out.append(t[:, 0:3] + b1 * t[:, 3:6] + b2 * t[:, 6:9])
    return torch.stack(out)


def _pcg_next(state, inc):
    """One PCG32 (XSH RR) output of every lane; advances `state`."""
    old = state.copy()
    state *= U64(PCG_MUL)
    state += inc
    x = (((old >> U64(18)) ^ old) >> U64(27)) & U64(0xffffffff)
    rot = old >> U64(59)
    return ((x >> rot) | (x << ((U64(32) - rot) & U64(31)))) & \
        U64(0xffffffff)


def host_wire_points(meshes, seeds, n_points):
    """[K, n_points, 3] f32 of the host wire: mesh k from a PCG32 stream
    seeded seeds[k] (stream constant PCG_SEQ); per point three uniforms
    u = next / 2^32 in f64: the face draw rf = u F against the alias table,
    then s = sqrt(f32(u)) and w = f32(u), the point a + b1 e1 + b2 e2 with
    b1 = s (1 - w), b2 = s w, all in f32."""
    K = len(meshes)
    with np.errstate(over='ignore'):
        inc = np.full(K, ((PCG_SEQ << 1) | 1) & 0xffffffffffffffff, U64)
        state = np.zeros(K, U64)
        _pcg_next(state, inc)
        state += np.asarray(seeds, U64)
        _pcg_next(state, inc)
        draws = np.empty((n_points, 3, K), np.float64)
        for i in range(n_points):
            for j in range(3):
                draws[i, j] = _pcg_next(state, inc) * (1.0 / 4294967296.0)
    out = np.empty((K, n_points, 3), np.float32)
    for k, mesh in enumerate(meshes):
        rf = draws[:, 0, k] * float(mesh.n_faces)
        lo = np.minimum(rf.astype(np.int64), mesh.n_faces - 1)
        face = np.where(rf - lo >= mesh.prob[lo], mesh.alias[lo], lo)
        s = np.sqrt(draws[:, 1, k].astype(np.float32))
        w = draws[:, 2, k].astype(np.float32)
        b1 = (s * (np.float32(1.0) - w))[:, None]
        b2 = (s * w)[:, None]
        t = mesh.tri[face].astype(np.float64)
        # a + b1 e1 + b2 e2 as two fused multiply-adds, as the native
        # sampler's compiler contracts it (f64 products of f32 are exact)
        inner = (b1.astype(np.float64) * t[:, 3:6] + t[:, 0:3])
        out[k] = b2.astype(np.float64) * t[:, 6:9] + \
            inner.astype(np.float32).astype(np.float64)
    return out


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def expand(rows, counts, max_parts):
    """Packed part rows [K, N, 3] + part counts -> ([B, P, N, 3] with the
    valid parts first and zeros after, valids [B, P] f32)."""
    B = len(counts)
    out = rows.new_zeros((B, max_parts) + tuple(rows.shape[1:]))
    valids = rows.new_zeros((B, max_parts))
    k = 0
    for b, n in enumerate(counts):
        out[b, :n] = rows[k:k + n]
        valids[b, :n] = 1.0
        k += n
    return out, valids


def geometry_batch(items, indices, epoch, cfg, wire, meshes, device):
    """A geometric batch before augmentation: `part_pcs_raw`, `part_valids`
    and the empty labels, on `device`.  `wire` is 'slot' or 'host'; the
    host wire's rows travel as `wire_dtype` (f16 by default)."""
    n_points = int(cfg['data']['num_pc_points'])
    paths, seeds, counts = [], [], []
    epoch_seed = int(epoch) * EPOCH_SEED_MUL
    for index in indices:
        files = items[int(index)][1]
        counts.append(len(files))
        paths += files
        seeds += [epoch_seed + int(index) * 64 + i for i in range(len(files))]
    mesh_list = [meshes(p) for p in paths]
    if wire == 'slot':
        batch_seed = (epoch_seed + int(indices[0])) & 0x7fffffff
        rows = slot_wire_points(mesh_list, batch_seed, n_points, device)
    else:
        rows = host_wire_points(mesh_list, seeds, n_points)
        wire_dtype = np.dtype(cfg['data'].get('wire_dtype', 'float16'))
        rows = torch.from_numpy(rows.astype(wire_dtype).astype(np.float32))
        rows = rows.to(device)
    pcs, valids = expand(rows, counts, int(cfg['data']['max_num_part']))
    B, P = valids.shape
    return {'part_pcs_raw': pcs, 'part_valids': valids,
            'part_label': pcs.new_zeros((B, P, 0)),
            'instance_label': pcs.new_zeros((B, P, 0))}


def partnet_batch(items, indices, cfg, device):
    """A PartNet batch: the stored clouds on the f16 grid, the stored poses,
    the nth-instance one-hot labels and the groups of equivalent parts."""
    P = int(cfg['data']['max_num_part'])
    N = int(cfg['data']['num_pc_points'])
    B = len(indices)
    pcs = np.zeros((B, P, N, 3), np.float32)
    trans = np.zeros((B, P, 3), np.float32)
    quat = np.zeros((B, P, 4), np.float32)
    valids = np.zeros((B, P), np.float32)
    inst = np.zeros((B, P, P), np.float32)
    match = np.zeros((B, P), np.float32)
    for b, index in enumerate(indices):
        raw = np.load(items[int(index)][1], allow_pickle=True).item()
        n = raw['part_pcs'].shape[0]
        pcs[b, :n] = np.asarray(raw['part_pcs'], np.float32).astype(
            np.float16).astype(np.float32)
        trans[b, :n] = raw['part_poses'][:, :3]
        quat[b, :n] = raw['part_poses'][:, 3:]
        valids[b, :n] = 1.0
        geo = np.asarray(raw['geo_part_ids']).astype(np.int64)
        seen = {}
        group = 1
        for j in range(n):
            inst[b, j, seen.get(geo[j], 0)] = 1.0
            seen[geo[j]] = seen.get(geo[j], 0) + 1
        for g in range(1, int(geo.max()) + 1):
            idx = np.where(geo == g)[0]
            if len(idx) > 1:
                match[b, idx] = group
                group += 1
    t = {k: torch.from_numpy(v).to(device) for k, v in (
        ('part_pcs', pcs), ('part_trans', trans), ('part_quat', quat),
        ('part_valids', valids), ('instance_label', inst),
        ('match_ids', match))}
    t['part_label'] = t['part_pcs'].new_zeros((B, P, 0))
    return t


# ---------------------------------------------------------------------------
# augmentation and quaternions
# ---------------------------------------------------------------------------


def quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    s = 2.0 / torch.clamp((q * q).sum(-1), min=1e-8)
    return torch.stack([
        1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w),
        s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w),
        s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def augment(batch, generator):
    """Each part recentred on its centroid and turned by a uniform random
    rotation: unit 4D Gaussians from `generator` ([B, P, 4], every slot
    drawn), real part made non-negative.  The ground truth is the centroid
    and the inverse rotation, zero at padded parts."""
    raw, valids = batch['part_pcs_raw'], batch['part_valids']
    B, P = valids.shape
    centroid = raw.mean(2)
    pcs = raw - centroid[:, :, None]
    q = torch.randn((B, P, 4), generator=generator, device=raw.device)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    q = torch.where(q[..., :1] < 0, -q, q)
    pcs = torch.einsum('bpij,bpnj->bpni', quat_to_matrix(q), pcs)
    inv = q * q.new_tensor([1.0, -1.0, -1.0, -1.0])
    v = valids[..., None]
    out = {k: v_ for k, v_ in batch.items() if k != 'part_pcs_raw'}
    out.update(part_pcs=pcs * v[..., None], part_quat=inv * v,
               part_trans=centroid * v)
    return out
