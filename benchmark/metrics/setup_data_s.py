"""setup_data_s: the run's set-up spent on data, in s: the union of the
program's spans `setup.data` (the split's index, the shapes read),
`setup.tables` (the device tables built and placed) and `data.mesh_load`
(the mesh registry's first parses, the host wire's in epoch 0 included),
utils/tracing.py, recorded before the traced epoch.  None where the
program keeps no such span.  Layer: host data."""

from benchmark.harness.program_trace import program_spans
from benchmark.harness.trace import merge

NAMES = ('setup.data', 'setup.tables', 'data.mesh_load')


def read(rec):
    tr = rec.get('trace', {}).get('trace')
    spans = program_spans()
    if tr is None or tr.span is None or spans is None:
        return None
    before = [(s.start_ns, s.end_ns) for s in spans
              if s.name in NAMES and s.end_ns <= tr.span[0]]
    if not before:
        return None
    return sum(e - s for s, e in merge(before)) / 1e9
