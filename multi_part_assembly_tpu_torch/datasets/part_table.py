"""Resident point table of a semantic (PartNet) split on the card.

Port of multi_part_assembly_tpu/datasets/part_table.py.  PartNet's part
clouds are stored, not sampled, so every valid part's cloud goes to the
device once, and each batch ships only `part_slots [B, P]` int32, the
table row of each part (the slot wire).

The table is `[T, N, 3]` float16: each coordinate on the f16 grid, as the
host wire's f16 rows quantise it and as JAX's split planes hold it (JAX
:53-64; there hi + lo == f16(v) exactly).  `gather_part_table` is a row
gather, a cast to f32 and a multiply by the 0/1 valid mask, so it gives
JAX's hi + lo sum bit for bit.  The JAX package's one-hot matmul and its
row threshold are devices of the TPU's matrix unit and are not ported.
"""

import numpy as np
import torch

__all__ = ['PartPointTable', 'build_part_table', 'gather_part_table']


class PartPointTable:
    """The resident table and the host's slot map.

    table: [T, N, 3] float16 on the device
    slot_base: np [n_items] int64, the first row of each dataset item
    """

    def __init__(self, table, slot_base, n_points):
        self.table = table
        self.slot_base = slot_base
        self.n_points = n_points

    @property
    def nbytes(self):
        return self.table.numel() * self.table.element_size()


def build_part_table(dataset, device, budget_bytes=4 << 30):
    """Pack every valid part cloud of a PartNetPartDataset, in item order,
    into a table on `device` (JAX :67-101).  Returns a PartPointTable, or
    None when the split is empty or the table would exceed `budget_bytes`
    (the host wire then stays in effect)."""
    raws = [dataset._load_raw(sid) for sid in dataset.shape_ids]
    counts = [r['part_pcs'].shape[0] for r in raws]
    total = int(np.sum(counts, dtype=np.int64))
    if total == 0:
        return None
    n_points = raws[0]['part_pcs'].shape[1]
    if total * n_points * 3 * 2 > budget_bytes:
        return None
    table = np.zeros((total, n_points, 3), np.float16)
    slot_base = np.zeros(len(raws), np.int64)
    off = 0
    for i, raw in enumerate(raws):
        pcs = np.asarray(raw['part_pcs'], np.float32)
        slot_base[i] = off
        table[off:off + len(pcs)] = pcs.astype(np.float16)
        off += len(pcs)
    return PartPointTable(torch.from_numpy(table).to(device), slot_base,
                          n_points)


def gather_part_table(table, part_slots, part_valids):
    """[T, N, 3] f16 table + [B, P] slots -> [B, P, N, 3] f32; invalid
    parts come out zero (JAX :146-157)."""
    B, P = part_slots.shape
    rows = table.index_select(0, part_slots.reshape(B * P).long())
    pcs = rows.float() * part_valids.reshape(B * P, 1, 1)
    return pcs.reshape(B, P, *table.shape[1:])
