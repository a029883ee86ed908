"""flush_idle_ms: the device's idle time inside the program's log flushes
(its spans `train.flush`, utils/tracing.py, in the traced epoch), in ms a
flush: each flush's length less the device activity inside it (every
kernel, copy and memset, merged).  The spans are the program's own,
stamped on the clock of the device trace; None where the program keeps
none, or the trace has no device activity.  Layer: dispatch."""

from benchmark.harness.program_trace import program_spans
from benchmark.harness.trace import merge


def read(rec):
    tr = rec.get('trace', {}).get('trace')
    spans = program_spans()
    if tr is None or tr.span is None or not tr.device or spans is None:
        return None
    s0, e0 = tr.span
    flushes = [(s.start_ns, s.end_ns) for s in spans
               if s.name == 'train.flush' and s0 <= s.start_ns and
               s.end_ns <= e0]
    if not flushes:
        return None
    busy = merge([(s, e) for _, s, e in tr.device])
    idle = 0
    for fs, fe in flushes:
        covered = sum(max(0, min(e, fe) - max(s, fs)) for s, e in busy)
        idle += (fe - fs) - covered
    return idle / 1e6 / len(flushes)
