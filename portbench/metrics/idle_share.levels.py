"""idle_share.levels (%): the share of the traced window in which no
device event runs while the host is inside one of the program's
``whitted.level`` spans and outside the ``sync.*`` spans within it: card
time lost while the host launches the levels' work. The spans come from the
program's span recorder (``cuda_pathtracer_tpu_torch/utils/profiling.py``),
stamped on the clock of the profiler's events; nothing when the program
recorded no level."""
import bisect


def read(rec):
    if rec.get('kind') != 'frames' or rec.get('events') is None:
        return None
    try:
        from cuda_pathtracer_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    got = [s for s in spans() if s.end_ns is not None]
    levels = [s for s in got if s.name == 'whitted.level']
    if not levels:
        return None
    by_id = {s.id: s for s in got}
    cuts = {s.id: [] for s in levels}
    for s in got:
        if not s.name.startswith('sync.'):
            continue
        p = by_id.get(s.parent)
        while p is not None and p.id not in cuts:
            p = by_id.get(p.parent)
        if p is not None:
            cuts[p.id].append((s.start_ns / 1e3, s.end_ns / 1e3))
    # the host's intervals (us) inside a level and outside its syncs
    host = []
    for lv in levels:
        at = lv.start_ns / 1e3
        for a, b in sorted(cuts[lv.id]):
            if a > at:
                host.append((at, a))
            at = max(at, b)
        if lv.end_ns / 1e3 > at:
            host.append((at, lv.end_ns / 1e3))
    # the device's busy union, disjoint and sorted
    busy = []
    for _, a, b in sorted(rec['events'], key=lambda e: e[1]):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    starts = [a for a, _ in busy]
    idle = 0.0
    for a, b in host:
        idle += b - a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            idle -= max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
    return 100.0 * idle / (rec['window_s'] * 1e6)
