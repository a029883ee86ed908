"""epoch_start_ms: the training thread's wait for the traced epoch's first
batch, in ms: the program's span `data.wait` of batch 0 (utils/tracing.py),
which holds the loader's start (the epoch's shuffle, its threads started,
the first collate and placement).  None where the program keeps no such
span.  Layer: host data."""

from benchmark.harness.program_trace import program_spans


def read(rec):
    tr = rec.get('trace', {}).get('trace')
    spans = program_spans()
    if tr is None or tr.span is None or spans is None:
        return None
    s0, e0 = tr.span
    waits = [s for s in spans if s.name == 'data.wait' and
             s.ids.get('batch') == 0 and s0 <= s.start_ns and s.end_ns <= e0]
    if not waits:
        return None
    return (waits[0].end_ns - waits[0].start_ns) / 1e6
