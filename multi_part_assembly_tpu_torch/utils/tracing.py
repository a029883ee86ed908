"""The port's tracer: host spans, counters, and region marks on the device.

Host spans.  `span(name, **ids)` is a context manager that records the
name, its start and end on `time.time_ns()`, the thread and the span it
opened inside, and opens a `torch.profiler.record_function` range of the
same name, so that every span shows in any torch.profiler trace (the
ranges of other threads only where the profiler records them).  kineto
stamps its ranges and the device activity it maps from CUPTI on that same
clock (Unix nanoseconds), so a span lines up with the device's kernels
without conversion.  Spans are kept only while a torch profiler records,
judged from the profiler's own state; otherwise a span costs one flag
check.  `always=True` keeps a span whatever the profiler does: set-up and
the mesh registry's first parses, which happen a bounded number of times
a run.  `timed=True` reads the clock without keeping the span, for a
caller that wants its seconds (`Span.seconds`).  The record holds the last
MAX_SPANS spans; `spans()` reads it, `reset()` empties it.

Counters.  `count(name, n)` adds to an integer counter, always on;
`counters()` reads them.

Names in use (docs/torch_port.md, "Tracing"): spans `data.collate`,
`data.place`, `data.wait`, `data.epoch_start`, `data.mesh_load`,
`train.epoch`, `train.gather`, `train.dispatch`, `train.flush`
(`train.flush.fetch`, `train.flush.write`), `setup.data`,
`setup.tables`, `setup.capture`, `setup.build`, `ckpt.write`; counters
`data.batches`, `data.starved`, `data.valid_parts`, `data.valid_pairs`,
`data.match_pairs`, `step.slots`, `gnn.pair_rows`, `gru.steps`, and
`launch.<key>`, one a hand-written kernel's launch (ops/cuda_build.py
`launch`; `nn_parts`, `nn_diag`, `bwd_parts`, `bwd_diag`, `nn_off`,
`nn_dir`, `sample_dense`, `sample_chunked`, `lap`, `lap_cost`,
`bn_moments`, `bn_apply`, `bn_backward`, `pool_fwd`, `pool_bwd`),
counted where the Python runs: in a traced step body, not in a graph's
replay; regions `augment`, `encoder`, `masked_bn`, `max_pool`,
`transformer`, `pose_head`, `loss`, `matching`, `lap_cost`,
`optimizer`, and the graph families' `relation`, `edge_mlp`, `gru`,
`node_mlp`.

Region marks.  Host ranges do not survive a CUDA graph's replay, so the
step marks its regions on the device: `region_begin(name, *tensors)` and
`region_end(name, *tensors)` launch the kernels `mpa_mark_<name>_begin`
and `mpa_mark_<name>_end` (csrc/marks.cu: one thread, no work) on the
current stream, and pass the tensors through an identity whose backward
launches `mpa_mark_<name>_bwd_end` (at the region's input) and
`mpa_mark_<name>_bwd_begin` (at its output).  A region whose inputs need
no gradient (the encoder reads the clouds) ends its backward where the
backward pass itself ends: `end_backward()`, after `loss.backward()`.
`region(name, device)` marks a region without a backward.  A region's
device time is the interval from its begin mark's end to its end mark's
start.  On a CPU tensor nothing is launched and no autograd node is made,
so the CPU's numbers are those of unmarked code, bit for bit.
"""

import contextlib
import itertools
import threading
import time
from collections import Counter, deque

import torch
import torch.autograd.profiler as _profiler

__all__ = ['span', 'Span', 'recording', 'spans', 'reset', 'count',
           'counters', 'MAX_SPANS', 'region', 'region_begin', 'region_end',
           'end_backward', 'clear_backward']

MAX_SPANS = 1 << 16

_record = deque(maxlen=MAX_SPANS)
_counters = Counter()
_lock = threading.Lock()
_local = threading.local()
_sids = itertools.count(1)


def recording():
    """Whether a torch profiler is recording, in any thread."""
    flag = getattr(_profiler, '_is_profiler_enabled', None)
    return torch.autograd._profiler_enabled() if flag is None else flag


def _stack():
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span: `sid`, `name`, `ids` (a dict), `thread` (its name),
    `parent` (the sid of the span it opened inside, or None), `start_ns`,
    `end_ns` (time.time_ns())."""

    __slots__ = ('sid', 'name', 'ids', 'thread', 'parent', 'start_ns',
                 'end_ns', '_keep', '_range')

    def __init__(self, name, ids, keep):
        self.name, self.ids, self._keep = name, ids, keep
        self.sid = self.parent = self.thread = self._range = None
        self.start_ns = self.end_ns = None

    @property
    def seconds(self):
        return None if self.end_ns is None else \
            (self.end_ns - self.start_ns) / 1e9

    def as_dict(self):
        return {'sid': self.sid, 'name': self.name, 'ids': self.ids,
                'thread': self.thread, 'parent': self.parent,
                'start_ns': self.start_ns, 'end_ns': self.end_ns}

    def __enter__(self):
        if self._keep:
            stack = _stack()
            self.sid = next(_sids)
            self.parent = stack[-1].sid if stack else None
            self.thread = threading.current_thread().name
            stack.append(self)
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.end_ns is not None:  # closed already
            return False
        self.end_ns = time.time_ns()
        if self._keep:
            self._range.__exit__(*exc)
            self._range = None
            stack = _stack()
            if self in stack:  # the last, unless closed out of order
                stack.remove(self)
            _record.append(self)
        return False


class _Off:
    """What `span` gives when nothing is kept or timed."""

    seconds = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name, always=False, timed=False, **ids):
    """A span named `name` with the identifiers `ids` (module docstring)."""
    keep = always or recording()
    if keep or timed:
        return Span(name, ids, keep)
    return _OFF


def spans():
    """The kept spans, oldest first (a copy)."""
    return list(_record)


def reset():
    """Empty the record of spans and the counters."""
    _record.clear()
    with _lock:
        _counters.clear()


def count(name, n=1):
    """Add `n` to the counter `name`."""
    with _lock:
        _counters[name] += int(n)


def counters():
    """The counters (a copy)."""
    with _lock:
        return dict(_counters)


# ---------------------------------------------------------------------------
# region marks
# ---------------------------------------------------------------------------

_marks = None  # (the kernels' library, region edge -> mark id)
_PENDING_MAX = 64  # regions awaiting end_backward, at most


def _library():
    """The kernels' library and its marks (csrc/marks.cu): region edge
    ('encoder_begin', 'encoder_bwd_end', ...) -> mark id."""
    global _marks
    if _marks is None:
        from ..ops.cuda_build import load_library
        lib = load_library()
        _marks = lib, {lib.mpa_mark_name(i).decode(): i
                       for i in range(lib.mpa_mark_count())}
    return _marks


def _launch(edge, device):
    """Launch the mark `mpa_mark_<edge>` on `device`'s current stream."""
    lib, ids = _library()
    if device.index is not None and \
            device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            rc = lib.mpa_mark(ids[edge],
                              torch.cuda.current_stream().cuda_stream)
    else:
        rc = lib.mpa_mark(ids[edge],
                          torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'mpa_mark {edge}: CUDA error {rc}')


class _Edge(torch.autograd.Function):
    """Identity on its tensors; its backward launches a mark."""

    @staticmethod
    def forward(ctx, edge, device, *xs):
        ctx.edge, ctx.device = edge, device
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        _launch(ctx.edge, ctx.device)
        return (None, None) + grads


def _device(tensors):
    for t in tensors:
        if torch.is_tensor(t):
            return t.device
    return None


def _on_card(device):
    return device is not None and device.type == 'cuda'


def _pending():
    pending = getattr(_local, 'pending', None)
    if pending is None:
        pending = _local.pending = []
    return pending


def _edge(name, bwd_edge, device, tensors):
    """`tensors` with those that need a gradient passed through _Edge."""
    idx = [i for i, t in enumerate(tensors)
           if torch.is_tensor(t) and t.requires_grad]
    if not idx or not torch.is_grad_enabled():
        return tensors, False
    out = list(tensors)
    for i, t in zip(idx, _Edge.apply(f'{name}_{bwd_edge}', device,
                                     *[tensors[i] for i in idx])):
        out[i] = t
    return tuple(out), True


def region_begin(name, *tensors):
    """Open region `name` on the tensors' device: its begin mark, and the
    tensors passed on (a tuple), their gradient launching its `_bwd_end`
    mark.  Nothing happens off CUDA."""
    device = _device(tensors)
    if not _on_card(device):
        return tensors
    _launch(f'{name}_begin', device)
    tensors, graded = _edge(name, 'bwd_end', device, tensors)
    if not graded and torch.is_grad_enabled():
        pending = _pending()
        if len(pending) < _PENDING_MAX:
            pending.append((name, device))
    return tensors


def region_end(name, *tensors):
    """Close region `name`: its end mark, and the tensors passed on, their
    gradient launching its `_bwd_begin` mark."""
    device = _device(tensors)
    if not _on_card(device):
        return tensors
    _launch(f'{name}_end', device)
    tensors, graded = _edge(name, 'bwd_begin', device, tensors)
    if not graded:  # no backward: its end is not awaited
        pending = _pending()
        for i in range(len(pending) - 1, -1, -1):
            if pending[i][0] == name:
                del pending[i]
                break
    return tensors


def end_backward():
    """After the backward pass: the `_bwd_end` marks of the regions whose
    inputs needed no gradient, innermost first."""
    pending = _pending()
    while pending:
        name, device = pending.pop()
        _launch(f'{name}_bwd_end', device)


def clear_backward():
    """Forget the regions awaiting `end_backward` (a forward without a
    backward)."""
    _pending().clear()


@contextlib.contextmanager
def region(name, device):
    """Mark region `name`, which has no backward, on `device`."""
    device = torch.device(device)
    on_card = _on_card(device)
    if on_card:
        _launch(f'{name}_begin', device)
    yield
    if on_card:
        _launch(f'{name}_end', device)
