"""chamfer_roofline: the least time of the traced epoch's chamfer
launches (harness/roofline.py, on each step's own part counts) over the
device time of the chamfer kernels found by name in the trace
(`chamfer_pair_kernel`, `chamfer_grad_kernel`, their prep and unpack).
A step runs the chamfer once for each MoN sample and supervised iteration
of its model family (harness/flops.py `chamfer_calls`).  Layer: kernels."""

from benchmark.harness import flops, roofline

KERNELS = r'^chamfer_(pair|grad|prep|unpack)_kernel'


def read(rec):
    t = rec.get('trace', {})
    tr = t.get('trace')
    if tr is None or tr.span is None:
        return None
    seconds = tr.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    d = rec['cfg']['data']
    calls = flops.chamfer_calls(rec['cfg'])
    least = sum(roofline.chamfer_step_bound_s(
        c, int(d['max_num_part']), int(d['num_pc_points']), calls)
        for c in t['batch_counts'])
    return 100.0 * least / seconds
