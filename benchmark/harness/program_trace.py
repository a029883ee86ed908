"""What the per-layer readers take from the program's own tracing
(multi_part_assembly_tpu_torch/utils/tracing.py): its region marks in the
device list of the traced epoch, and its host spans from the tracer's
record in this process.  Both are None where the program has none, so a
reader of them reads nothing on a program without tracing."""

import re

MARK = re.compile(r'mpa_mark_(\w+?)_(begin|end)\b')


def program_spans():
    """The tracer's kept spans, or None where the program has no tracer."""
    try:
        from multi_part_assembly_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans()


def region_seconds(device, regions, span):
    """Seconds inside `span` ((start, end) ns) between the begin and end
    marks of each region named in `regions`, summed over the regions, in
    the device list `device` ((name, start ns, end ns)); None when no mark
    of them is there.  The program marks a region with kernels of no work
    (csrc/marks.cu), `mpa_mark_<region>_begin` and `mpa_mark_<region>_end`,
    in every replay of its step's CUDA graph; the region runs from the end
    of its begin mark to the start of its end mark.  A region's begin and
    end pair innermost first."""
    s0, e0 = span
    opened = {r: [] for r in regions}
    total, found = 0, False
    for name, s, e in sorted(device, key=lambda d: d[1]):
        m = MARK.search(name)
        if m is None or m.group(1) not in opened:
            continue
        found = True
        stack = opened[m.group(1)]
        if m.group(2) == 'begin':
            stack.append(e)
        elif stack:
            start = max(stack.pop(), s0)
            total += max(0, min(s, e0) - start)
    return total / 1e9 if found else None


def region_ms_a_step(rec, regions):
    """The regions' device time in ms a step of the traced epoch, or None
    where the trace holds none of their marks."""
    t = rec.get('trace', {})
    tr = t.get('trace')
    if tr is None or tr.span is None or not t.get('batch_counts'):
        return None
    seconds = region_seconds(tr.device, regions, tr.span)
    if seconds is None:
        return None
    return 1e3 * seconds / len(t['batch_counts'])
