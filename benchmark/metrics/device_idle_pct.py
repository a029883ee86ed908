"""device_idle_pct: the share of the traced epoch (two log flushes and an
epoch boundary) in which no kernel, copy or memset ran on the device, from
torch.profiler's device activity.  Layer: dispatch."""


def read(rec):
    tr = rec.get('trace', {}).get('trace')
    if tr is None or tr.span is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
