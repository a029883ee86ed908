"""PartNet (semantic assembly) data: the host dataset and its two wires.

Port of multi_part_assembly_tpu/datasets/partnet.py:18-347.  Each shape is
a DGL-preprocessed npy dict (`part_pcs, part_poses, part_ids,
geo_part_ids, sym`) with a contact-point side file; items are padded to
max_num_part and carry the labels the JAX dataset derives: the
nth-instance-within-class one-hot `instance_label`, the one-hot
`part_label` only when `data_keys` has it (else `[P, 0]`), the `match_ids`
groups of equivalent parts, `contact_points`, `sym` and `valid_matrix`.

Two wires, each collating whole batches (`collate_batch`):

  * the host wire: the batch's valid part clouds packed as rows of
    `data.wire_dtype` (default float16) (`part_pcs__packed [K, N, 3]`)
    with `pack_index [B, P]`, unpacked on the card by
    `geometry.unpack_parts`.  Exactly K rows ship: the JAX package pads K
    to one of 8 buckets to bound its jit shapes, which eager PyTorch has no
    use for;
  * the slot wire (`enable_device_table`): every cloud lives on the card
    in a resident f16 table (datasets/part_table.py) and the batch ships
    only `part_slots [B, P]`, each part's table row.

On the f16 grid (the default) both give the clouds bit for bit as the JAX
wires do.
"""

import collections
import os
import threading

import numpy as np

from .geometry import DataLoader, wire_array
from .mesh_io import f32_to_f16

__all__ = ['PartNetPartDataset', 'enable_device_table',
           'build_partnet_dataloader']


def _collate(items):
    """Stack a list of item dicts (JAX loader.py `DataLoader._collate`):
    scalars become a [B] array, arrays gain a leading batch axis."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if np.isscalar(vals[0]) or np.asarray(vals[0]).ndim == 0:
            out[k] = np.asarray(vals)
        else:
            out[k] = np.stack(vals, axis=0)
    return out


class PartNetPartDataset:
    """Shape list filtered by part count, a raw-dict LRU and a derived-label
    LRU behind one lock (the loader's producer thread and the table build
    both read them), padded items, and the batch collates of both wires."""

    def __init__(self, data_dir, data_fn, data_keys, num_part_category=20,
                 min_num_part=2, max_num_part=20, shuffle_parts=False,
                 overfit=-1, level=3, cache_items=2048,
                 wire_dtype='float16'):
        self.data_dir = data_dir
        self.data_fn = data_fn
        self.num_part_category = num_part_category
        self.min_num_part = min_num_part
        self.max_num_part = max_num_part
        self.shuffle_parts = shuffle_parts
        self.level = level
        self.data_keys = tuple(data_keys)
        self.wire_dtype = np.dtype(wire_dtype)  # the host wire's rows
        self._cache_items = cache_items
        self._raw_cache = collections.OrderedDict()
        self._item_cache = collections.OrderedDict()  # labels, no clouds
        self._cache_lock = threading.Lock()
        self.shape_ids = self._read_data(data_fn)
        if overfit > 0:
            self.shape_ids = self.shape_ids[:overfit]
        # set by enable_device_table: collate_batch then ships slots
        self._device_ptable = None

    def _shape_path(self, shape_id):
        return os.path.join(self.data_dir, 'shape_data',
                            f'{shape_id}_level{self.level}.npy')

    def _read_data(self, data_fn):
        """Keep the shapes whose part count is in range (JAX :62-72)."""
        shape_ids = np.load(os.path.join(self.data_dir, data_fn))
        valid = []
        for shape_id in shape_ids:
            data = np.load(self._shape_path(shape_id),
                           allow_pickle=True).item()
            if self.min_num_part <= data['part_pcs'].shape[0] <= \
                    self.max_num_part:
                valid.append(shape_id)
        return valid

    def _pad_data(self, data):
        data = np.asarray(data)
        out = np.zeros((self.max_num_part, ) + tuple(data.shape[1:]),
                       np.float32)
        out[:data.shape[0]] = data
        return out

    def set_epoch(self, epoch):
        pass  # PartNet clouds are stored: nothing to resample

    def __len__(self):
        return len(self.shape_ids)

    def _cached(self, key, load):
        with self._cache_lock:
            hit = self._raw_cache.get(key)
            if hit is not None:
                self._raw_cache.move_to_end(key)
                return hit
        data = load()
        with self._cache_lock:
            self._raw_cache[key] = data
            while len(self._raw_cache) > self._cache_items:
                self._raw_cache.popitem(last=False)
        return data

    def _load_raw(self, shape_id):
        return self._cached(shape_id, lambda: np.load(
            self._shape_path(shape_id), allow_pickle=True).item())

    def _load_contacts(self, shape_id):
        fn = os.path.join(
            self.data_dir, 'contact_points',
            f'pairs_with_contact_points_{shape_id}_level{self.level}.npy')
        return self._cached(('contacts', shape_id),
                            lambda: np.load(fn, allow_pickle=True))

    def __getitem__(self, index):
        return self._item(index)[0]

    def _item(self, index, include_pcs=True):
        """One padded item (JAX :111-236): (dict, the shape's raw dict after
        the part shuffle, num_parts, the shuffle's permutation or None)."""
        shape_id = self.shape_ids[index]
        cur_data = self._load_raw(shape_id)
        num_parts = cur_data['part_pcs'].shape[0]
        assert self.min_num_part <= num_parts <= self.max_num_part

        perm = None
        if self.shuffle_parts:
            perm = np.random.permutation(num_parts)
            cur_data = {k: np.asarray(v)[perm] for k, v in cur_data.items()}
        else:
            with self._cache_lock:
                cached = self._item_cache.get(index)
                if cached is not None:
                    self._item_cache.move_to_end(index)
            if cached is not None:
                data_dict = dict(cached)
                if include_pcs:
                    data_dict['part_pcs'] = self._pad_data(
                        cur_data['part_pcs'])
                return data_dict, cur_data, num_parts, None

        P = self.max_num_part
        data_dict = {}
        if include_pcs:
            data_dict['part_pcs'] = self._pad_data(cur_data['part_pcs'])
        pose = self._pad_data(cur_data['part_poses'])  # [P, 3 + 4]
        data_dict['part_trans'] = pose[:, :3]
        data_dict['part_quat'] = pose[:, 3:]
        valids = np.zeros((P, ), np.float32)
        valids[:num_parts] = 1.0
        data_dict['part_valids'] = valids
        data_dict['data_id'] = index
        data_dict['shape_id'] = int(shape_id)

        # the nth instance of its geometry class, one-hot
        instance_label = np.zeros((P, P), np.float32)
        geo_ids = np.asarray(cur_data['geo_part_ids'])
        seen = [0] * (int(max(geo_ids)) + 1)
        for j in range(num_parts):
            g = int(geo_ids[j])
            instance_label[j, seen[g]] = 1
            seen[g] += 1
        data_dict['instance_label'] = instance_label

        if 'part_label' in self.data_keys:  # one-hot semantic class
            label = np.asarray(cur_data['part_ids']) - 1
            one_hot = np.zeros((num_parts, self.num_part_category),
                               np.float32)
            one_hot[np.arange(num_parts), label.astype(int)] = 1.0
            data_dict['part_label'] = self._pad_data(one_hot)
        else:
            data_dict['part_label'] = np.zeros((P, 0), np.float32)

        for key in self.data_keys:
            if key == 'part_label':
                continue
            if key == 'part_ids':
                data_dict['part_ids'] = self._pad_data(geo_ids)
            elif key == 'match_ids':
                # groups of two or more equivalent parts, numbered from 1
                out = self._pad_data(geo_ids)
                group = 1
                for g in range(1, int(out.max()) + 1):
                    idx = np.where(out == g)[0]
                    if len(idx) == 0:
                        continue
                    if len(idx) == 1:
                        out[idx] = 0
                    else:
                        out[idx] = group
                        group += 1
                data_dict['match_ids'] = out
            elif key == 'contact_points':
                out = np.zeros((P, P, 4), np.float32)
                out[:num_parts, :num_parts] = self._load_contacts(shape_id)
                data_dict['contact_points'] = out
            elif key == 'sym':
                data_dict['sym'] = self._pad_data(cur_data['sym'])
            elif key == 'valid_matrix':
                vm = np.zeros((P, P), np.float32)
                vm[:num_parts, :num_parts] = 1.0
                data_dict['valid_matrix'] = vm
            else:
                raise ValueError(f'ERROR: unknown data {key}')

        if not self.shuffle_parts:
            small = {k: v for k, v in data_dict.items() if k != 'part_pcs'}
            with self._cache_lock:
                self._item_cache[index] = small
                while len(self._item_cache) > self._cache_items:
                    self._item_cache.popitem(last=False)
        return data_dict, cur_data, num_parts, perm

    def collate_batch(self, indices):
        """One batch of numpy arrays: the slot wire once a table is set,
        else the host wire's packed rows of `wire_dtype` (JAX :238-285),
        converted by the native f16 pass (`mesh_io.f32_to_f16`) into
        pinned memory when a card is present."""
        if self._device_ptable is not None:
            return self._collate_table_slots(indices)
        dicts, pcs = [], []
        for index in indices:
            d, cur_data, _, _ = self._item(index, include_pcs=False)
            dicts.append(d)
            pcs.append(np.asarray(cur_data['part_pcs'], np.float32))
        batch = _collate(dicts)
        counts = np.asarray([p.shape[0] for p in pcs], np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        row = np.arange(self.max_num_part)[None, :]
        mask = row < counts[:, None]
        pack_index = np.zeros(mask.shape, np.int32)
        pack_index[mask] = (offsets[:, None] + row)[mask]
        packed = wire_array((int(counts.sum()), ) + pcs[0].shape[1:],
                            self.wire_dtype)
        for off, p in zip(offsets, pcs):
            if self.wire_dtype == np.float16:  # one native pass a cloud
                f32_to_f16(np.ascontiguousarray(p), packed[off:off + len(p)])
            else:
                packed[off:off + len(p)] = p
        batch['part_pcs__packed'] = packed
        batch['pack_index'] = pack_index
        return batch

    def _collate_table_slots(self, indices):
        """The slot wire (JAX :287-310): `part_slots [B, P]` int32, the
        table rows of the parts (the part shuffle applied), with the label
        arrays; the clouds stay on the card."""
        slot_base = self._device_ptable.slot_base
        dicts, slot_rows = [], []
        for index in indices:
            d, _, num_parts, perm = self._item(index, include_pcs=False)
            dicts.append(d)
            row = np.zeros(self.max_num_part, np.int32)
            local = perm if perm is not None else np.arange(num_parts)
            row[:num_parts] = slot_base[index] + local
            slot_rows.append(row)
        batch = _collate(dicts)
        batch['part_slots'] = np.stack(slot_rows)
        batch['__ptable__'] = self._device_ptable
        return batch


def enable_device_table(loader, cfg, device, budget_bytes=4 << 30):
    """Switch a PartNet loader to the slot wire (JAX :313-347): build the
    split's table once on `device` and have the dataset's collate ship
    slots.  Returns the PartPointTable, or None when the loader is not
    PartNet's or the table would exceed the budget (the host wire then
    stays in effect)."""
    from .part_table import build_part_table
    ds = loader.dataset
    if not isinstance(ds, PartNetPartDataset):
        return None
    if ds._device_ptable is None:
        ds._device_ptable = build_part_table(ds, device,
                                             budget_bytes=budget_bytes)
    return ds._device_ptable


def build_partnet_dataloader(cfg):
    """Train and val loaders (JAX :350-377): the train split shuffles its
    order (and its parts, by `data.shuffle_parts`) and drops the last
    partial batch; val runs 2x batch."""
    common = dict(
        data_dir=cfg.data.data_dir,
        data_keys=cfg.data.data_keys,
        num_part_category=cfg.data.num_part_category,
        min_num_part=cfg.data.min_num_part,
        max_num_part=cfg.data.max_num_part,
        overfit=cfg.data.overfit,
        wire_dtype=cfg.data.get('wire_dtype', 'float16'),
    )
    train_set = PartNetPartDataset(
        data_fn=cfg.data.data_fn.format('train'),
        shuffle_parts=cfg.data.shuffle_parts, **common)
    val_set = PartNetPartDataset(
        data_fn=cfg.data.data_fn.format('val'), shuffle_parts=False,
        **common)
    seed = cfg.exp.get('seed', 0)
    train_loader = DataLoader(train_set, cfg.exp.batch_size, shuffle=True,
                              drop_last=True, seed=seed)
    val_loader = DataLoader(val_set, cfg.exp.batch_size * 2, shuffle=False,
                            drop_last=False, seed=seed)
    return train_loader, val_loader
