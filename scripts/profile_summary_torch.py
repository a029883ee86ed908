"""Summarise the torch.profiler trace that `scripts/train_torch.py
--profile DIR` writes (DIR/trace.json, Chrome trace format): device time
and launch count per kernel, and the device's busy and idle share of the
traced window.  Counterpart of scripts/profile_summary.py, which reads
jax.profiler traces.

    python scripts/profile_summary_torch.py DIR [--top 30] [--host]

Device kernels are the trace's events of category `kernel`, memcpy and
memset (GPU activity, CUPTI); the idle share is one minus the union of
their intervals over the span from the first to the last of them.  A
trace with no device event (a CPU run) says so: its device numbers are
not measured.  `--host` adds the host-side operator table.
"""

import argparse
import collections
import json
import os

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def load_events(path):
    """The trace's complete ('X') events; `path` is the trace file or the
    directory holding trace.json."""
    if os.path.isdir(path):
        path = os.path.join(path, 'trace.json')
    if not os.path.exists(path):
        raise SystemExit(f'no trace at {path}')
    with open(path) as f:
        data = json.load(f)
    events = data['traceEvents'] if isinstance(data, dict) else data
    return [e for e in events if e.get('ph') == 'X' and 'dur' in e]


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def summarize(events, top=30, host=False):
    """{'kernels': [(name, total_us, count)], 'busy_us', 'span_us',
    'idle_share' (None when no device event), 'host': [...]}."""
    dev = [e for e in events if e.get('cat', '').lower() in DEVICE_CATS]
    dur, cnt = collections.Counter(), collections.Counter()
    for e in dev:
        dur[e['name']] += float(e['dur'])
        cnt[e['name']] += 1
    out = {'kernels': [(n, d, cnt[n]) for n, d in dur.most_common(top)],
           'busy_us': None, 'span_us': None, 'idle_share': None,
           'host': []}
    if dev:
        spans = [(float(e['ts']), float(e['ts']) + float(e['dur']))
                 for e in dev]
        span = max(e for _, e in spans) - min(s for s, _ in spans)
        busy = _busy_us(spans)
        out.update(busy_us=busy, span_us=span,
                   idle_share=1.0 - busy / span if span > 0 else 0.0)
    if host:
        hd, hc = collections.Counter(), collections.Counter()
        for e in events:
            if e.get('cat') == 'cpu_op':
                hd[e['name']] += float(e['dur'])
                hc[e['name']] += 1
        out['host'] = [(n, d, hc[n]) for n, d in hd.most_common(top)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('trace', help='trace.json or the directory holding it')
    ap.add_argument('--top', type=int, default=30)
    ap.add_argument('--host', action='store_true',
                    help='also list host-side operators')
    args = ap.parse_args(argv)
    s = summarize(load_events(args.trace), args.top, args.host)
    if s['idle_share'] is None:
        print('no device events in the trace: device time not measured')
    else:
        print(f'device busy {s["busy_us"] / 1e3:.3f} ms of a '
              f'{s["span_us"] / 1e3:.3f} ms window: idle '
              f'{100 * s["idle_share"]:.1f}%')
        total = sum(d for _, d, _ in s['kernels']) or 1.0
        print(f'{"total_ms":>10} {"calls":>6} {"%dev":>6}  kernel')
        for name, d, c in s['kernels']:
            print(f'{d / 1e3:10.3f} {c:6d} {100 * d / total:6.1f}  '
                  f'{name[:90]}')
    if args.host:
        print(f'{"host_ms":>10} {"calls":>6}  operator')
        for name, d, c in s['host']:
            print(f'{d / 1e3:10.3f} {c:6d}  {name[:90]}')
    return s


if __name__ == '__main__':
    main()
