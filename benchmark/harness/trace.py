"""Reading a torch.profiler trace of the traced window.

The device's activity is every kernel, copy and memset the profiler
records (CUPTI), kernels replayed from a CUDA graph included.  The span is
the host range `bench.window` that the harness opens around the traced
epoch; `bench.*` ranges that it opens around the loader's hand-over, the
dispatch of a group and the log flush name what the host was doing during
a gap on the device.
"""

import re

import torch

DEVICE_ACTIVITIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
WINDOW = 'bench.window'


def short_name(name):
    """A kernel's name without its return type, namespaces' noise and
    arguments."""
    name = name.replace('(anonymous namespace)::', '')
    name = re.sub(r'^void ', '', name)
    return name.split('(')[0].strip() or name


def merge(intervals):
    """Sorted, overlapping [start, end) intervals merged."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _kind(ev):
    """The profiler's activity type of a raw event ('kernel',
    'gpu_memcpy', 'user_annotation', ...); from its device and annotation
    flag where this PyTorch does not report it."""
    if hasattr(ev, 'activity_type'):
        return ev.activity_type()
    flag = getattr(ev, 'is_user_annotation', None)
    annotation = flag() if flag else ev.name().startswith('bench.')
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        return 'gpu_user_annotation' if annotation else 'kernel'
    return 'user_annotation' if annotation else 'cpu_op'


class Trace:
    """Device activity and host ranges of a profile, in ns on one clock."""

    def __init__(self, prof):
        self.device, self.host = [], []
        for ev in prof.profiler.kineto_results.events():
            kind = _kind(ev)
            if kind in DEVICE_ACTIVITIES:
                self.device.append((ev.name(), ev.start_ns(), ev.end_ns()))
            elif kind == 'user_annotation' and ev.name().startswith('bench.'):
                self.host.append((ev.name(), ev.start_ns(), ev.end_ns()))
        spans = [(s, e) for n, s, e in self.host if n == WINDOW]
        self.span = spans[0] if spans else None

    def _clipped(self):
        s0, e0 = self.span
        return merge([(max(s, s0), min(e, e0)) for _, s, e in self.device
                      if e > s0 and s < e0])

    @property
    def window_s(self):
        return (self.span[1] - self.span[0]) / 1e9

    @property
    def busy_s(self):
        return sum(e - s for s, e in self._clipped()) / 1e9

    def kernel_seconds(self, pattern):
        """Summed device seconds, inside the span, of kernels whose short
        name matches the regular expression `pattern`."""
        rx = re.compile(pattern)
        s0, e0 = self.span
        return sum(min(e, e0) - max(s, s0) for n, s, e in self.device
                   if e > s0 and s < e0 and rx.search(short_name(n))) / 1e9

    def top_ops(self, k=10):
        """[[name, device seconds]] of the k operations that took most
        device time in the span."""
        s0, e0 = self.span
        totals = {}
        for n, s, e in self.device:
            if e > s0 and s < e0:
                key = short_name(n)
                totals[key] = totals.get(key, 0) + min(e, e0) - max(s, s0)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t / 1e9] for n, t in top]

    def idle_gaps(self, k=10):
        """[[what the host was doing, seconds]] of the k longest gaps on
        the device in the span: the `bench.*` range (not the window's own)
        that covers most of the gap, else 'other'."""
        s0, e0 = self.span
        busy = self._clipped()
        edges = [s0] + [x for iv in busy for x in iv] + [e0]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out = []
        for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            cover = {}
            for n, s, e in self.host:
                if n != WINDOW and e > gs and s < ge:
                    cover[n] = cover.get(n, 0) + min(e, ge) - max(s, gs)
            label = max(cover, key=cover.get) if cover else 'other'
            out.append([label, (ge - gs) / 1e9])
        return out
