"""Breaking-Bad geometric-assembly data: host dataset, loader, the wires'
expansion, and the on-device augmentation.

Port of multi_part_assembly_tpu/datasets/geometry.py:51-313 (the host
dataset and its single-shard collates), :427-486 (`unpack_parts`,
`expand_geometry_batch`), :563-627 (`augment_geometry_batch`), :630-701
(`enable_device_sampling`, the loaders) and of datasets/loader.py (the
`DataLoader`).  Two wires, each collating whole batches in one call
(`collate_batch`):

  * the host wire: the batch's valid part clouds sampled on the host in
    one native call, straight into packed rows of `data.wire_dtype`
    (default float16, the JAX package's default; 'float32' ships them
    unrounded), written into pinned memory when a card is present.  The
    card upcasts the rows to f32 and expands them into the dense batch
    (`expand_geometry_batch`);
  * the slot wire (device sampling, datasets/device_sampler.py): the host
    ships only the piece slot of each packed part row, the part counts and
    a seed, and the card draws the points from resident tables.

`__getitem__` stays, a sample's dense f32 item.  The JAX loader's
per-item path (`batch_collate=False` over an `exp.num_workers` pool) serves
several devices in one process; each rank of the port drives one device,
so its loader always collates whole batches and has no such path.

Step grouping (`exp.steps_per_call`) is the trainer's: a group's batches
are taken one by one from this loader and each feeds one replay of the
compiled step (train/step.py), so no stacked group batch exists here.  The
JAX package's sharded wires serve a TPU mesh and are not ported: under
data parallelism each rank drives one device and collates its own shard
(`DataLoader`).
"""

import math
import os
import queue
import threading

import numpy as np
import torch

from ..parallel import dist
from ..utils import tracing
from ..utils.rotation import (quaternion_invert, quaternion_multiply,
                              quaternion_to_matrix)
from ..utils.transforms import random_quaternions
from .mesh_io import MeshSampler

__all__ = ['GeometryPartDataset', 'DataLoader', 'augment_geometry_batch',
           'unpack_parts', 'expand_geometry_batch', 'enable_device_sampling',
           'build_geometry_dataloader', 'wire_array']

_MESH_EXTS = ('.obj', '.off', '.ply', '.stl')
_PREFETCH = 2  # batches each stage of the loader keeps ready


def _mesh_names(folder):
    return sorted(f for f in os.listdir(folder)
                  if f.lower().endswith(_MESH_EXTS))


_TORCH_DTYPES = {np.dtype(np.float16): torch.float16,
                 np.dtype(np.float32): torch.float32}


def wire_array(shape, dtype):
    """An empty numpy array for a host-wire buffer: the view of a pinned
    tensor when a card is present, so that the copy to the card reads it
    in place and `_to_tensors` takes the tensor back without a copy."""
    if torch.cuda.is_available():
        return torch.empty(shape, dtype=_TORCH_DTYPES[np.dtype(dtype)],
                           pin_memory=True).numpy()
    return np.empty(shape, dtype)


class GeometryPartDataset:
    """Fracture-directory walk, part-count filter and per-epoch surface
    sampling (JAX geometry.py:51-174).  Items are numpy dicts:
    part_pcs_raw [P, N, 3] f32 (zero-padded), part_valids [P] f32, empty
    part/instance labels, the `data_keys` extras and data_id.
    `wire_dtype` (float16 or float32) is the host wire's row type."""

    def __init__(self, data_dir, data_fn, data_keys, category='',
                 num_points=1000, min_num_part=2, max_num_part=20,
                 shuffle_parts=False, overfit=-1, sampler=None,
                 wire_dtype='float16'):
        self.category = category if category.lower() != 'all' else ''
        self.data_dir = data_dir
        self.num_points = num_points
        self.min_num_part = min_num_part
        self.max_num_part = max_num_part
        self.shuffle_parts = shuffle_parts
        self.data_keys = tuple(data_keys)
        # the native sampler rounds on store (the same sample stream), so
        # an f16 row is f16 of the f32 row: at most 2.4e-4 off at unit
        # scale (JAX geometry.py:72-78)
        self.wire_dtype = np.dtype(wire_dtype)
        if self.wire_dtype not in _TORCH_DTYPES:
            raise ValueError(f'data.wire_dtype: float16 or float32, got '
                             f'{wire_dtype!r}')
        self.sampler = sampler or MeshSampler()
        self.data_list = self._read_data(data_fn)
        if overfit > 0:
            self.data_list = self.data_list[:overfit]
        self._epoch_seed = 0
        self._file_cache = {}
        # sampling tables (datasets/device_sampler.py), set by
        # enable_device_sampling: collate_batch then emits the slot wire
        self._device_tables = None

    def _read_data(self, data_fn):
        with open(os.path.join(self.data_dir, data_fn)) as f:
            mesh_list = [line.strip() for line in f.readlines()]
        if self.category:
            mesh_list = [line for line in mesh_list
                         if self.category in line.split('/')]
        data_list = []
        for mesh in mesh_list:
            mesh_dir = os.path.join(self.data_dir, mesh)
            if not os.path.isdir(mesh_dir):
                print(f'{mesh} does not exist')
                continue
            for frac in sorted(os.listdir(mesh_dir)):
                if 'fractured' not in frac and 'mode' not in frac:
                    continue
                frac_rel = os.path.join(mesh, frac)
                num_parts = len(_mesh_names(
                    os.path.join(self.data_dir, frac_rel)))
                if self.min_num_part <= num_parts <= self.max_num_part:
                    data_list.append(frac_rel)
        return data_list

    def set_epoch(self, epoch):
        """Reseed the per-epoch surface resampling."""
        self._epoch_seed = int(epoch) * 1000003

    def __len__(self):
        return len(self.data_list)

    def _mesh_files(self, index):
        cached = self._file_cache.get(index)
        if cached is None:
            folder = os.path.join(self.data_dir, self.data_list[index])
            cached = [os.path.join(folder, f) for f in _mesh_names(folder)]
            self._file_cache[index] = cached
        if self.shuffle_parts:
            return [cached[i] for i in np.random.permutation(len(cached))]
        return cached

    def __getitem__(self, index):
        files = self._mesh_files(index)
        num_parts = len(files)
        P, N = self.max_num_part, self.num_points
        seeds = [self._epoch_seed + index * 64 + i for i in range(num_parts)]
        part_pcs = np.zeros((P, N, 3), np.float32)
        part_pcs[:num_parts] = self.sampler.sample_batch(files, N, seeds)
        valids = np.zeros((P, ), np.float32)
        valids[:num_parts] = 1.0
        item = {
            'part_pcs_raw': part_pcs,
            'part_valids': valids,
            'data_id': index,
            'instance_label': np.zeros((P, 0), np.float32),
            'part_label': np.zeros((P, 0), np.float32),
        }
        for key in self.data_keys:
            if key == 'part_ids':
                ids = np.zeros((P, ), np.float32)
                ids[:num_parts] = np.arange(num_parts)
                item['part_ids'] = ids
            elif key == 'valid_matrix':
                vm = np.zeros((P, P), np.float32)
                vm[:num_parts, :num_parts] = 1.0
                item['valid_matrix'] = vm
            else:
                raise ValueError(f'ERROR: unknown data {key}')
        return item

    def all_mesh_paths(self):
        """Every piece mesh path in this split, in a stable order (the
        sampling tables' slots; bypasses part shuffling)."""
        paths = []
        for item in self.data_list:
            folder = os.path.join(self.data_dir, item)
            paths += [os.path.join(folder, f) for f in _mesh_names(folder)]
        return paths

    def _collate_slots(self, indices):
        """The slot wire (JAX geometry.py:209-244, single shard): which
        piece each packed part row is (`part_slots__packed` [K] int32, the
        batch's valid parts in order), the per-sample part counts [B] and
        one sampling seed; the card draws the points itself
        (device_sampler.sample_and_expand).

        Exactly K rows are shipped.  The JAX package pads K up to one of 8
        buckets (`_kpad`) to bound the jit shape variants; eager PyTorch
        compiles nothing per shape, so it has no use for them."""
        slot_of = self._device_tables.slot_of
        slots, counts = [], []
        for index in indices:
            files = self._mesh_files(index)
            counts.append(len(files))
            slots += [slot_of[f] for f in files]
        # deterministic per (epoch, batch): the epoch's order is seeded, so
        # indices[0] is unique per batch within an epoch
        seed = np.int32((self._epoch_seed + int(indices[0])) & 0x7fffffff)
        return {
            'part_slots__packed': np.asarray(slots, np.int32),
            'part_counts': np.asarray(counts, np.int32),
            'sample_seed': seed,
            '__tables__': self._device_tables,
            'data_id': np.asarray(indices, np.int64),
        }

    def collate_batch(self, indices):
        """One batch of numpy arrays: the slot wire once sampling tables
        are set (JAX geometry.py:290-291), else the host wire (JAX
        geometry.py:273-313 at one shard): the batch's K part meshes
        sampled in ONE native call, mesh i of sample b with the seed
        `epoch_seed + index * 64 + i` of its item, straight into
        `part_pcs_raw__packed [K, N, 3]` of `wire_dtype` (pinned memory
        when a card is present), beside `part_counts [B] int32` and
        `data_id`.  Everything else the step needs derives on the device
        from the counts (`expand_geometry_batch`).

        Exactly K rows are shipped.  The JAX package pads K up to one of 8
        buckets (`_kpad`) to bound its jit shapes; the port expands outside
        the captured step, so it has no use for them."""
        if self._device_tables is not None:
            return self._collate_slots(indices)
        paths, seeds, counts = [], [], []
        for index in indices:
            files = self._mesh_files(index)
            counts.append(len(files))
            paths += files
            seeds += [self._epoch_seed + int(index) * 64 + i
                      for i in range(len(files))]
        packed = wire_array((len(paths), self.num_points, 3), self.wire_dtype)
        self.sampler.sample_batch(paths, self.num_points, seeds, out=packed)
        return {
            'part_pcs_raw__packed': packed,
            'part_counts': np.asarray(counts, np.int32),
            'data_id': np.asarray(indices, np.int64),
        }


def _to_tensors(batch, pin):
    """numpy values -> CPU tensors (pinned when `pin`); other values, such
    as the slot wire's tables, pass through.  A view of a pinned tensor
    (`wire_array`) gives back that tensor, uncopied: its storage is the
    pinned block, which the caching host allocator keeps from reuse until
    the copies that read it are done."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, np.generic)):
            base = getattr(v, 'base', None)
            if pin and isinstance(base, torch.Tensor) and \
                    base.is_pinned() and base.shape == v.shape and \
                    base.data_ptr() == v.ctypes.data:
                v = base
            else:
                v = torch.from_numpy(np.asarray(v))
                if pin:
                    v = v.pin_memory()
        out[k] = v
    return out


class DataLoader:
    """Batches of a dataset as dicts of CPU tensors (pinned when a card is
    present), made ahead of the consumer by producer threads (JAX
    datasets/loader.py:20-220).

    The order is JAX's (loader.py:73-85): `np.random.default_rng(seed +
    epoch)` shuffles arange(n) in place, and rank r of `world` takes
    order[r::world], cut to n // world indices, so every rank runs the same
    number of steps.  `rank` and `world` default to the process group's
    (parallel/dist.py).

    The dataset collates each batch whole (`collate_batch(indices)`, JAX
    `batch_collate`) and so chooses the wire: packed host rows, or slots
    once device tables are set.

    `transform`, when set, is a second producer stage (loader.py:149-208):
    one thread collates, a second applies the transform to each batch (the
    trainer's device placement, train/trainer.py `DevicePlacement`), each
    keeping _PREFETCH batches ready.  Both stop when the consumer
    abandons the iterator, which joins them; an exception in either is
    raised in the consumer.

    Spans (utils/tracing.py), each with the batch's (epoch, batch):
    `data.collate` on the collate thread, `data.place` on the transform
    thread, `data.wait` for the consumer's hand-over, and
    `data.epoch_start` from the iterator's start to its first batch.
    Counters: `data.valid_parts`, `data.valid_pairs` (the sum of each
    shape's squared part count) and, on semantic data, `data.match_pairs`
    (the sum of each group's squared size) at collate, `data.batches` and
    `data.starved` (a hand-over that found no batch ready) at the
    hand-over."""

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False,
                 seed=0, rank=None, world=None, transform=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.rank = dist.rank() if rank is None else int(rank)
        self.world = dist.world() if world is None else int(world)
        self.transform = transform

    def __len__(self):
        n = len(self.dataset) // self.world  # this rank's shard
        return n // self.batch_size if self.drop_last else \
            math.ceil(n / self.batch_size)

    def set_epoch(self, epoch):
        self.epoch = int(epoch)
        self.dataset.set_epoch(epoch)

    def _indices(self):
        """This rank's indices of the epoch, in order."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        return order[self.rank::self.world][:n // self.world]

    def _batches(self):
        order = self._indices()
        for i in range(len(self)):
            yield order[i * self.batch_size:(i + 1) * self.batch_size]

    def __iter__(self):
        epoch = self.epoch
        opening = tracing.span('data.epoch_start', epoch=epoch)
        opening.__enter__()
        pin = torch.cuda.is_available()
        stop = threading.Event()
        done = object()
        out_q = queue.Queue(maxsize=_PREFETCH)

        def put(q, item):
            """Stop-aware put: False once the consumer has gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def collate(q):
            try:
                for n, idx in enumerate(self._batches()):
                    if stop.is_set():
                        return
                    with tracing.span('data.collate', epoch=epoch, batch=n):
                        batch = self.dataset.collate_batch(
                            [int(i) for i in idx])
                        tensors = _to_tensors(batch, pin)
                    tracing.count('data.valid_parts', _valid_parts(batch))
                    tracing.count('data.valid_pairs', _valid_pairs(batch))
                    if 'match_ids' in batch:
                        tracing.count('data.match_pairs',
                                      _match_pairs(batch['match_ids']))
                    if not put(q, (n, tensors)):
                        return
            except Exception as e:  # re-raised in the consumer
                put(q, e)
                return
            put(q, done)

        def transform(in_q):
            while not stop.is_set():
                try:
                    item = in_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if stop.is_set():
                    return
                if isinstance(item, tuple):
                    n, batch = item
                    try:
                        with tracing.span('data.place', epoch=epoch,
                                          batch=n):
                            item = n, self.transform(batch)
                    except Exception as e:  # re-raised in the consumer
                        item = e
                if not put(out_q, item) or item is done or \
                        isinstance(item, Exception):
                    return

        queues = [out_q]
        if self.transform is None:
            stages = [(collate, out_q)]
        else:
            queues.append(queue.Queue(maxsize=_PREFETCH))
            stages = [(collate, queues[1]), (transform, queues[1])]
        threads = [threading.Thread(target=fn, args=(q, ), daemon=True,
                                    name=f'loader-{fn.__name__}')
                   for fn, q in stages]
        for t in threads:
            t.start()
        try:
            n = 0
            while True:
                if out_q.empty():
                    tracing.count('data.starved')
                with tracing.span('data.wait', epoch=epoch, batch=n):
                    item = out_q.get()
                if opening is not None:
                    opening.__exit__(None, None, None)
                    opening = None
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                tracing.count('data.batches')
                n += 1
                yield item[1]
        finally:
            if opening is not None:
                opening.__exit__(None, None, None)
            stop.set()
            for q in queues:  # wakes a stage blocked on a full queue
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
            for t in threads:
                t.join()


def _part_counts(batch):
    """Each shape's valid parts in a collated batch: its part counts
    (geometric wires) or its valid part slots (PartNet); None without
    either."""
    if 'part_counts' in batch:
        return np.asarray(batch['part_counts'], np.int64)
    if 'part_valids' in batch:
        return np.count_nonzero(np.asarray(batch['part_valids']), axis=-1)
    return None


def _valid_parts(batch):
    """The valid parts of a collated batch."""
    counts = _part_counts(batch)
    return 0 if counts is None else int(np.sum(counts))


def _valid_pairs(batch):
    """The valid part pairs of a collated batch: the sum of each shape's
    squared part count, the rows of a pair MLP over valid parts."""
    counts = _part_counts(batch)
    return 0 if counts is None else int(np.sum(counts ** 2))


def _match_pairs(match_ids):
    """The in-group part pairs of a batch's `match_ids` [B, P]: over its
    shapes, the sum of each group's squared size (a group: equal nonzero
    ids), the entries of the LAP cost that kernel L2 computes."""
    ids = np.asarray(match_ids).astype(np.int64)
    return sum(int(np.sum(np.bincount(row[row > 0]) ** 2)) for row in ids)


def unpack_parts(part_pcs_packed, pack_index, part_valids):
    """[K, N, 3] packed rows + [B, P] row index -> [B, P, N, 3], padded
    parts zeroed (JAX geometry.py:427-446).  An index gather: the JAX
    package's one-hot matmul is a device of the TPU's MXU."""
    pcs = part_pcs_packed[pack_index.long()]
    return torch.where(part_valids[..., None, None] > 0, pcs,
                       torch.zeros((), dtype=pcs.dtype, device=pcs.device))


def expand_geometry_batch(part_pcs_packed, part_counts, max_parts,
                          data_keys=('part_ids', 'valid_matrix')):
    """Packed rows [K, N, 3] (f16 or f32) + part counts [B] -> the full
    dense batch, on their device (JAX geometry.py:449-486): the rows
    upcast to f32 (exact), then part_valids, the row index, part_ids,
    valid_matrix and the empty labels derive from the counts.  Valid parts
    are a prefix of the part axis."""
    B = part_counts.shape[0]
    P = max_parts
    device = part_counts.device
    counts = part_counts.to(torch.int64)
    row = torch.arange(P, device=device)[None, :]            # [1, P]
    mask = row < counts[:, None]                             # [B, P]
    valids = mask.float()
    offsets = torch.cumsum(counts, 0) - counts               # [B]
    pack_index = torch.where(mask, offsets[:, None] + row, 0)
    batch = {
        'part_pcs_raw': unpack_parts(part_pcs_packed.float(), pack_index,
                                     valids),
        'part_valids': valids,
        'instance_label': torch.zeros((B, P, 0), device=device),
        'part_label': torch.zeros((B, P, 0), device=device),
    }
    for key in data_keys:
        if key == 'part_ids':
            batch['part_ids'] = torch.where(mask, row, 0).float()
        elif key == 'valid_matrix':
            batch['valid_matrix'] = valids[:, :, None] * valids[:, None, :]
        else:
            raise ValueError(f'ERROR: unknown data {key}')
    return batch


def augment_geometry_batch(part_pcs_raw, part_valids, generator=None,
                           rot_range=-1.0, quat=None):
    """Recentre each part, rotate it randomly, and return the pose that
    undoes it (JAX geometry.py:563-627).

    Args:
        part_pcs_raw: [B, P, N, 3];  part_valids: [B, P]
        generator: torch.Generator on the tensors' device
        rot_range: > 0 draws Euler angles in [-rot_range, rot_range] degrees
            (extrinsic xyz), else a uniform SO(3) rotation
        quat: optional [B, P, 4] rotations to apply instead of drawing them

    Returns:
        dict(part_pcs, part_quat, part_trans): GT quat is the inverse of the
        applied rotation, GT trans the part's centroid; zero at padded parts.
    """
    B, P, N, _ = part_pcs_raw.shape
    device = part_pcs_raw.device
    valid = part_valids[..., None]  # [B, P, 1]
    centroid = part_pcs_raw.mean(2)  # [B, P, 3]
    pcs = part_pcs_raw - centroid[:, :, None, :]

    if quat is None and rot_range > 0:
        euler = (torch.rand((B, P, 3), generator=generator, device=device)
                 - 0.5) * 2.0 * rot_range * (math.pi / 180.0)
        half = euler * 0.5
        c, s = torch.cos(half), torch.sin(half)
        zeros = torch.zeros_like(half[..., 0])

        def axis_quat(axis):
            comps = [c[..., axis], zeros, zeros, zeros]
            comps[1 + axis] = s[..., axis]
            return torch.stack(comps, dim=-1)

        quat = quaternion_multiply(
            axis_quat(2), quaternion_multiply(axis_quat(1), axis_quat(0)))
    elif quat is None:
        quat = random_quaternions((B, P), generator=generator, device=device)

    rmat = quaternion_to_matrix(quat)  # [B, P, 3, 3]
    # R p as a broadcast multiply-sum: exact f32 whatever the TF32 setting
    pcs = (rmat[:, :, None] * pcs[:, :, :, None, :]).sum(-1)
    gt_quat = quaternion_invert(quat)
    return {'part_pcs': pcs * valid[..., None],
            'part_quat': gt_quat * valid,
            'part_trans': centroid * valid}


def enable_device_sampling(loader, cfg, device):
    """Switch a geometry loader to the slot wire (JAX geometry.py:630-661).

    Builds the sampling tables of the loader's split once, places them on
    `device`, and has the dataset's collate emit piece slots instead of
    sampled points.  `cfg.data.device_table_layout` ('dense' or 'chunked';
    absent: the auto rule) picks the layout.  Returns the tables, or None
    when the dataset is not geometry or the tables would exceed the default
    budget: the host wire then stays in effect."""
    from .device_sampler import build_device_tables
    ds = loader.dataset
    if not isinstance(ds, GeometryPartDataset):
        return None
    if ds._device_tables is None:
        ds._device_tables = build_device_tables(
            ds.all_mesh_paths(), ds.sampler, device=device,
            layout=cfg.data.get('device_table_layout', None))
    return ds._device_tables


def build_geometry_dataloader(cfg, sampler=None):
    """Train and val loaders (JAX geometry.py:664-701): the train split
    shuffles and drops the last partial batch; val runs 2x batch.  Both
    collate whole batches, on the host wire in `data.wire_dtype` (default
    float16)."""
    common = dict(
        data_dir=cfg.data.data_dir,
        data_keys=cfg.data.data_keys,
        category=cfg.data.category,
        num_points=cfg.data.num_pc_points,
        min_num_part=cfg.data.min_num_part,
        max_num_part=cfg.data.max_num_part,
        overfit=cfg.data.overfit,
        sampler=sampler,
        wire_dtype=cfg.data.get('wire_dtype', 'float16'),
    )
    train_set = GeometryPartDataset(
        data_fn=cfg.data.data_fn.format('train'),
        shuffle_parts=cfg.data.shuffle_parts, **common)
    val_set = GeometryPartDataset(
        data_fn=cfg.data.data_fn.format('val'), shuffle_parts=False,
        **common)
    seed = cfg.exp.get('seed', 0)
    train_loader = DataLoader(train_set, cfg.exp.batch_size, shuffle=True,
                              drop_last=True, seed=seed)
    val_loader = DataLoader(val_set, cfg.exp.batch_size * 2, shuffle=False,
                            drop_last=False, seed=seed)
    return train_loader, val_loader
