"""step_mfu_pct: the model FLOPs of the window's steps (harness/flops.py,
valid parts only) over the window's seconds, as a share of the H100's
dense bf16 peak.  Layer: train step."""

from benchmark.harness import flops, roofline


def read(rec):
    counts = rec['window'].get('batch_counts')
    if not counts:
        return None
    total = sum(flops.step_flops(rec['cfg'], c) for c in counts)
    return 100.0 * total / rec['window']['seconds'] / \
        roofline.PEAK_BF16_FLOPS
