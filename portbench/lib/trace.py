"""The traced run's device records: the profiler's kernel events over the
window, their busy union (copied from the port's ``utils/profiling.py``:
``busy_us`` and ``is_kernel``'s rule), the breakdown the result line
carries, and the traversal waves recorded for the roofline readers (after
``chip_smoke.py``'s ``Recorder``)."""
from __future__ import annotations

import contextlib
from collections import defaultdict


@contextlib.contextmanager
def device_profile(enabled: bool):
    """``torch.profiler`` over the body with CUDA activity only (no CPU op
    is recorded, so the host-bound loop keeps near its untraced pace);
    yields a box whose ``events`` holds the kernel events, sorted, once the
    body ends. A no-op box when not ``enabled``."""
    box = {'events': None}
    if not enabled:
        yield box
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield box
        torch.cuda.synchronize()
    box['events'] = kernel_events(prof)


def kernel_events(prof):
    """Sorted (name, start_us, end_us) of the device events (kernels,
    copies and fills) of a finished profile. Read from the Kineto results
    (fast for a million events), else from ``prof.events()``."""
    out = []
    try:
        evs = prof.profiler.kineto_results.events()
        for e in evs:
            if str(e.device_type()).split('.')[-1] != 'CUDA':
                continue
            start = e.start_ns() / 1e3 if hasattr(e, 'start_ns') else e.start_us()
            dur = (e.duration_ns() / 1e3 if hasattr(e, 'duration_ns')
                   else e.duration_us())
            out.append((e.name(), float(start), float(start + dur)))
    except AttributeError:
        import torch
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out.append((e.name, float(e.time_range.start),
                            float(e.time_range.end)))
    return sorted((ev for ev in out if not ev[0].startswith('cpt/')),
                  key=lambda ev: ev[1])


def is_copy(name: str) -> bool:
    return name.lower().startswith(('memcpy', 'memset'))


def busy_us(spans, lo=float('-inf'), hi=float('inf')) -> tuple[float, int]:
    """Union (us) of the (start, end) intervals that start in [lo, hi),
    clipped to it, and their count. ``spans`` sorted by start."""
    busy, end, n = 0.0, float('-inf'), 0
    for s, e in spans:
        if not lo <= s < hi:
            continue
        n += 1
        e = min(e, hi)
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, n


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its template arguments, cut to ``width``."""
    base = name.split('<', 1)[0].split('(', 1)[0].strip() or name
    return base[:width]


def breakdown(events, top: int = 10) -> dict:
    """The result line's ``breakdown``: the ``top`` device operations by
    seconds, and the idle gaps between device operations summed by the
    operation the device waited for (what the host was issuing), longest
    first."""
    by_op = defaultdict(float)
    for name, s, e in events:
        by_op[short_name(name)] += (e - s) / 1e6
    gaps = defaultdict(float)
    end = None
    for name, s, e in events:
        if end is not None and s > end:
            gaps['host issue before ' + short_name(name, 80)] += (s - end) / 1e6
        end = e if end is None else max(end, e)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {'device_ops': [[k, v] for k, v in rank(by_op)],
            'idle_gaps': [[k, v] for k, v in rank(gaps)]}


class WaveRecorder:
    """Wraps the program's ``ops.dispatch.traverse_merged`` while armed and
    keeps clones of the arguments of its first ``len(names)`` calls, under
    those names (a loop's ``WAVES``: a Whitted frame's level 0, closest
    hit and shadow)."""

    def __init__(self, dispatch_module, names):
        self.module, self.names = dispatch_module, tuple(names)
        self.saved = {}
        self.armed = False
        self._orig = None

    def __enter__(self):
        self._orig = orig = self.module.traverse_merged

        def wrapped(*args, **kw):
            if self.armed and len(self.saved) < len(self.names):
                self.saved[self.names[len(self.saved)]] = (
                    tuple(a.clone() if hasattr(a, 'clone') else a
                          for a in args), dict(kw))
            return orig(*args, **kw)
        self.module.traverse_merged = wrapped
        return self

    def __exit__(self, *exc):
        self.module.traverse_merged = self._orig


def wave_rooflines(saved: dict, program_walk, plain_walk) -> list:
    """Each recorded wave timed through the program's walk (CUDA events
    behind the sleep pre-roll, 10 runs after one) and counted by the
    plain walk's visits and rows: a list of dicts with ``wave``,
    ``kernel_ms``, ``bound_ms``, ``bound_by``, ``rays``, ``live``."""
    from .timing import bound, cuda_ms
    from .work import traversal_work
    out = []
    for wave, ((table, ro, rd, t0, live, stop, *rest), kw) in saved.items():
        want_uv = bool(rest[0]) if rest else bool(kw.get('want_uv', False))
        ms, _ = cuda_ms(lambda: program_walk(table, ro, rd, t0, live, stop,
                                             want_uv),
                        reps=10, warmup=1, preroll=True)
        st = {}
        plain_walk(table, ro, rd, t0, live, stop, want_uv, stats=st)
        n_bytes, n_ops = traversal_work(ro.shape[0], 9 + (8 if want_uv else 0),
                                        st)
        b_ms, by = bound(n_bytes, n_ops)
        out.append(dict(wave=wave, kernel_ms=ms, bound_ms=b_ms, bound_by=by,
                        rays=int(ro.shape[0]), live=int(live.sum())))
    return out
