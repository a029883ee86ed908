"""Summarise the torch.profiler trace that `scripts/train_torch.py
--profile DIR` writes (DIR/trace.json, Chrome trace format): device time
and launch count per kernel, and the device's busy and idle share of the
traced window; the device time of each region of the train step, from the
program's region marks; and the program's own spans and counters
(DIR/spans.json, the tracer's record of every thread, utils/tracing.py),
with the longest idle gaps on the device and the spans of the training
thread that cover them.
Counterpart of scripts/profile_summary.py, which reads jax.profiler
traces.

    python scripts/profile_summary_torch.py DIR [--top 30] [--host]

Device kernels are the trace's events of category `kernel`, memcpy and
memset (GPU activity, CUPTI); the idle share is one minus the union of
their intervals over the span from the first to the last of them.  A
region runs from the end of its kernel `mpa_mark_<region>_begin` to the
start of `mpa_mark_<region>_end` (csrc/marks.cu), so it holds in every
replay of a CUDA graph; the outermost regions' cover is the share of the
busy time inside them.  A trace with no device event (a CPU run) says so:
its device numbers are not measured.  `--host` adds the host-side
operator table.
"""

import argparse
import collections
import json
import os
import re

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
MARK = re.compile(r'mpa_mark_(\w+?)_(begin|end)\b')


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


def load_spans(path):
    """The program's spans beside the trace (spans.json: the tracer's
    record, times in ns on the trace's clock), each with `ts` and `dur` in
    the trace's microseconds; [] when there is none."""
    folder = path if os.path.isdir(path) else os.path.dirname(path)
    trace = os.path.join(folder, 'trace.json') if os.path.isdir(path) \
        else path
    spans_path = os.path.join(folder, 'spans.json')
    if not os.path.exists(spans_path):
        return []
    with open(trace) as f:
        data = json.load(f)
    base = data.get('baseTimeNanoseconds', 0) if isinstance(data, dict) \
        else 0
    with open(spans_path) as f:
        spans = json.load(f)['spans']
    for s in spans:
        s['ts'] = (s['start_ns'] - base) / 1e3
        s['dur'] = (s['end_ns'] - s['start_ns']) / 1e3
    return spans


def _record(path):
    """spans.json beside the trace, {} when there is none."""
    folder = path if os.path.isdir(path) else os.path.dirname(path)
    spans_path = os.path.join(folder, 'spans.json')
    if not os.path.exists(spans_path):
        return {}
    with open(spans_path) as f:
        return json.load(f)


def load_counters(path):
    """The program's counters over the traced epoch (spans.json), {} when
    there are none."""
    return _record(path).get('counters', {})


def load_max_num_part(path):
    """The part slots of a shape in the traced run (spans.json), None when
    not recorded."""
    return _record(path).get('max_num_part')


def merge(intervals):
    """Sorted, overlapping [start, end) intervals merged."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    return sum(e - s for s, e in merge(intervals))


def _overlap(intervals, s0, e0):
    return sum(max(0.0, min(e, e0) - max(s, s0)) for s, e in intervals)


def regions(events):
    """[(region, start_us, end_us)] of the step's marked regions, in order
    of their begin marks: from the end of `mpa_mark_<r>_begin` to the
    start of `mpa_mark_<r>_end`, begin and end paired innermost first."""
    marks = sorted((float(e['ts']), float(e['dur']), m.group(1),
                    m.group(2)) for e in events
                   if e.get('cat', '').lower() == 'kernel'
                   for m in [MARK.search(e['name'])] if m)
    opened, out = {}, []
    for ts, dur, region, edge in marks:
        if edge == 'begin':
            opened.setdefault(region, []).append(len(out))
            out.append([region, ts + dur, None])
        elif opened.get(region):
            out[opened[region].pop()][2] = ts
    return [tuple(r) for r in out if r[2] is not None]


def region_table(events, steps=1):
    """{region: (device ms a step, intervals)} and the share of the busy
    device time inside the outermost regions (None without marks)."""
    found = regions(events)
    table = collections.OrderedDict()
    for region, s, e in found:
        ms, n = table.get(region, (0.0, 0))
        table[region] = (ms + (e - s) / 1e3 / steps, n + 1)
    if not found:
        return table, None
    outer = merge([(s, e) for _, s, e in found])
    dev = [(float(e['ts']), float(e['ts']) + float(e['dur']))
           for e in events if e.get('cat', '').lower() in DEVICE_CATS]
    busy = merge(dev)
    lo, hi = outer[0][0], outer[-1][1]
    # the busy time from the first region's start to the last's end
    inside = [(max(s, lo), min(e, hi)) for s, e in busy if e > lo and s < hi]
    total = sum(e - s for s, e in inside)
    covered = sum(_overlap(outer, s, e) for s, e in inside)
    return table, covered / total if total > 0 else None


def span_table(spans):
    """{name: (count, total ms, longest ms)} of the program's spans."""
    out = {}
    for s in spans:
        n, total, top = out.get(s['name'], (0, 0.0, 0.0))
        out[s['name']] = (n + 1, total + s['dur'] / 1e3,
                          max(top, s['dur'] / 1e3))
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def _label(spans, gs, ge):
    """The innermost of `spans` that covers half of [gs, ge), else the one
    that covers most of it, else None."""
    cover = [(_overlap([(s['ts'], s['ts'] + s['dur'])], gs, ge), s['ts'],
              s['name']) for s in spans]
    cover = [c for c in cover if c[0] > 0]
    half = [c for c in cover if c[0] >= (ge - gs) / 2]
    # a span inside another starts later
    return max(half, key=lambda c: c[1])[2] if half else \
        max(cover)[2] if cover else None


def idle_gaps(events, spans, top=10, thread='MainThread'):
    """The `top` longest idle gaps on the device, from its first activity
    to its last: [(start us, ms, share of the gap under `thread`'s spans,
    the innermost of them that covers half of it, else the one that covers
    most ('other' for none), {another thread: its span so chosen})]."""
    dev = merge([(float(e['ts']), float(e['ts']) + float(e['dur']))
                 for e in events
                 if e.get('cat', '').lower() in DEVICE_CATS])
    gaps = [(dev[i][1], dev[i + 1][0]) for i in range(len(dev) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    threads = {}
    for s in spans:
        threads.setdefault(s.get('thread'), []).append(s)
    own = threads.pop(thread, [])
    out = []
    for gs, ge in gaps:
        under = _overlap(merge([(s['ts'], s['ts'] + s['dur'])
                                for s in own]), gs, ge)
        others = {t: _label(ss, gs, ge) for t, ss in threads.items()}
        out.append((gs, (ge - gs) / 1e3, under / (ge - gs),
                    _label(own, gs, ge) or 'other',
                    {t: n for t, n in others.items() if n}))
    return out


def summarize(events, top=30, host=False, program_spans=(), steps=1,
              counters=None, max_num_part=None):
    """{'kernels': [(name, total_us, count)], 'busy_us', 'span_us',
    'idle_share' (None when no device event), 'host': [...], 'regions'
    ({region: (ms a step of `steps`, intervals)}), 'region_cover',
    'spans' (`span_table`), 'gaps' (`idle_gaps`), 'counters' (the
    program's), 'valid_share' (`data.valid_parts` over `step.slots`, None
    without them), 'valid_pair_share' (`data.valid_pairs` over
    `step.slots` x `max_num_part`, the share of a pair MLP's rows that
    pair two valid parts; None without them), 'match_pair_share'
    (`data.match_pairs` over the same, the share of the LAP cost's entries
    that lie inside a group; None without them)}."""
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
    out['regions'], out['region_cover'] = region_table(events, steps)
    out['spans'] = span_table(program_spans)
    out['gaps'] = idle_gaps(events, program_spans) if dev else []
    out['counters'] = dict(counters or {})
    slots = out['counters'].get('step.slots', 0)
    out['valid_share'] = out['counters'].get('data.valid_parts', 0) / \
        slots if slots else None
    for key, name in (('valid_pair_share', 'data.valid_pairs'),
                      ('match_pair_share', 'data.match_pairs')):
        pairs = out['counters'].get(name)
        out[key] = pairs / (slots * max_num_part) \
            if slots and max_num_part and pairs is not None else None
    return out


def report(s):
    """Print the summary `s` of `summarize`."""
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
    if s['regions']:
        print(f'{"ms/step":>10} {"times":>6}  region (outermost cover '
              f'{100 * (s["region_cover"] or 0):.1f}% of the busy time)')
        for region, (ms, n) in s['regions'].items():
            print(f'{ms:10.3f} {n:6d}  {region}')
    if s['spans']:
        print(f'{"total_ms":>10} {"count":>6} {"max_ms":>9}  program span')
        for name, (n, total, top) in s['spans'].items():
            print(f'{total:10.3f} {n:6d} {top:9.3f}  {name}')
    if s['counters']:
        print('program counters: ' + ', '.join(
            f'{k} {v}' for k, v in sorted(s['counters'].items())))
    if s['valid_share'] is not None:
        print(f'valid share of the part slots (data.valid_parts / '
              f'step.slots): {s["valid_share"]:.4f}')
    if s.get('valid_pair_share') is not None:
        print(f'valid share of the part pairs (data.valid_pairs / '
              f'(step.slots x max_num_part)): {s["valid_pair_share"]:.4f}')
    if s.get('match_pair_share') is not None:
        print(f'in-group share of the part pairs (data.match_pairs / '
              f'(step.slots x max_num_part)): {s["match_pair_share"]:.4f}')
    if s['gaps']:
        print(f'{"gap_ms":>10} {"spans%":>6}  longest device idle gaps: the '
              f'training thread\'s span; the other threads\'')
        for _, ms, under, label, others in s['gaps']:
            other = ', '.join(f'{t}: {n}' for t, n in sorted(others.items()))
            print(f'{ms:10.3f} {100 * under:6.1f}  {label}  {other}')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('trace', help='trace.json or the directory holding it')
    ap.add_argument('--top', type=int, default=30)
    ap.add_argument('--host', action='store_true',
                    help='also list host-side operators')
    args = ap.parse_args(argv)
    spans = load_spans(args.trace)
    steps = sum(sp['ids'].get('steps', 0) for sp in spans
                if sp['name'] == 'train.dispatch') or 1
    s = summarize(load_events(args.trace), args.top, args.host, spans,
                  steps, load_counters(args.trace),
                  load_max_num_part(args.trace))
    report(s)
    if args.host:
        print(f'{"host_ms":>10} {"calls":>6}  operator')
        for name, d, c in s['host']:
            print(f'{d / 1e3:10.3f} {c:6d}  {name[:90]}')
    return s


if __name__ == '__main__':
    main()
