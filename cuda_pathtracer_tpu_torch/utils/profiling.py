"""Profiling and observability (counterpart of
``cuda_pathtracer_tpu/utils/profiling.py``).

The reference's observability is printf: an FPS EMA every 60 ticks
(src/main.cpp:416-418) and BVH-build wall times (src/bvhBuilder.h:37,264).
Here: a span recorder (:func:`span`, :func:`record`, :func:`spans`), the FPS
EMA, a ``torch.profiler`` trace written to a directory with the recorded
spans beside the kernels, and the device time of a run by kernel category,
read from the profiler's CUDA kernels. ``utils/frame_profile.py`` builds its
per-band breakdown on the same kernel events (:func:`is_kernel`,
:func:`cuda_spans`, :func:`busy_us`).

Spans mark the port's own layer boundaries (``README.md``, "Tracing"). A
span keeps its name, start and end (``time.time_ns()``, the clock of the
profiler's events), its parent, a frame id shared by every span from one
frame's start to the next and a few integer attributes. Spans named
``sync.<site>`` wrap the host's waits for the device. Per-frame spans record
only while a trace is being taken: while a ``torch.profiler`` profile is
active, or inside :func:`record`. Set-up spans (``setup=True``) always
record. When off, :func:`span` returns a shared no-op context.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile


class Span:
    """One recorded span; ``parent`` is the enclosing span's ``id`` (None at
    the top), ``frame`` the frame id, times in ns of ``time.time_ns()``."""

    __slots__ = ('id', 'name', 'start_ns', 'end_ns', 'parent', 'frame',
                 'attrs', '_new_frame')

    def __init__(self, name: str, new_frame: bool):
        self.name = name
        self.attrs = {}
        self._new_frame = new_frame
        self.end_ns = None

    def __enter__(self):
        global _frame
        self.parent = _OPEN[-1].id if _OPEN else None
        if self._new_frame:
            _frame += 1
        self.frame = _frame
        self.id = len(_SPANS)
        _SPANS.append(self)
        _OPEN.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if _fence and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.end_ns = time.time_ns()
        _OPEN.pop()
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_SPANS: list[Span] = []      # every recorded span, in the order opened
_OPEN: list[Span] = []       # the spans open now, innermost last
_recording = 0               # open record() contexts
_fence = False
_frame = 0


def span(name: str, setup: bool = False, new_frame: bool = False):
    """A context that records the span ``name`` while a trace is being
    taken (always, for a ``setup`` span) and yields it, or else yields
    None at the cost of one flag test. ``new_frame`` starts a new frame
    id. Attributes go into the yielded span's ``attrs``."""
    if setup or _recording or _autograd_profiler._is_profiler_enabled:
        return Span(name, new_frame)
    return _NO_SPAN


@contextlib.contextmanager
def record(fence: bool = False):
    """Record per-frame spans inside the body, as under a profile; yields a
    list that holds the spans recorded inside it once the body ends. With
    ``fence`` every span ends by waiting for the CUDA device, so the device
    work it launched falls inside it."""
    global _recording, _fence
    first, was = len(_SPANS), _fence
    _recording += 1
    _fence = fence or was
    got = []
    try:
        yield got
    finally:
        _recording -= 1
        _fence = was
        got.extend(_SPANS[first:])


def spans() -> list:
    """Every span recorded in this process (since the last :func:`clear`)."""
    return list(_SPANS)


def clear() -> None:
    """Forget the recorded spans."""
    _SPANS.clear()


def span_totals(recorded) -> str:
    """Total host ms, count and mean per span name, largest total first."""
    tot, cnt = defaultdict(float), defaultdict(int)
    for s in recorded:
        if s.end_ns is not None:
            tot[s.name] += s.seconds
            cnt[s.name] += 1
    return '\n'.join(f'{n:24s} {tot[n] * 1e3:9.1f} ms total '
                     f'({tot[n] / cnt[n] * 1e3:8.2f} ms x {cnt[n]})'
                     for n in sorted(tot, key=tot.get, reverse=True))


class FpsMeter:
    """The running-average FPS of main.cpp:416-418 (EMA 0.95/0.05)."""

    def __init__(self, report_every: int = 60):
        self.ema = 0.0
        self.tick = 0
        self.report_every = report_every
        self._last = None

    def frame(self) -> float | None:
        """Call once per frame; returns the EMA when it's time to report."""
        now = time.perf_counter()
        if self._last is not None:
            fps = 1.0 / max(now - self._last, 1e-9)
            self.ema = self.ema * 0.95 + 0.05 * fps
        self._last = now
        self.tick += 1
        if self.tick % self.report_every == 0:
            return self.ema
        return None


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """A ``torch.profiler`` trace of the body, written as ``trace.json``
    (Chrome trace format, for chrome://tracing or Perfetto) into
    ``log_dir`` (default: ``cpt-torch-trace`` under the temporary
    directory), with the spans recorded inside it on a host track of
    their own ("cpt spans")."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), 'cpt-torch-trace')
    os.makedirs(log_dir, exist_ok=True)
    first = len(_SPANS)
    with profile(activities=_activities()) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, 'trace.json')
    prof.export_chrome_trace(path)
    _add_span_track(path, _SPANS[first:])


SPAN_TID = 0x7fff0000   # the span track's thread id in trace.json


def _add_span_track(path: str, recorded) -> None:
    """Append ``recorded`` to a Chrome trace as complete events on one host
    thread of this process."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get('baseTimeNanoseconds', 0)
    pid = os.getpid()
    events = trace.setdefault('traceEvents', [])
    events.append({'ph': 'M', 'name': 'thread_name', 'pid': pid,
                   'tid': SPAN_TID, 'args': {'name': 'cpt spans'}})
    for s in recorded:
        if s.end_ns is None:
            continue
        events.append({'ph': 'X', 'cat': 'cpt_span', 'name': s.name,
                       'pid': pid, 'tid': SPAN_TID,
                       'ts': (s.start_ns - base) / 1e3,
                       'dur': (s.end_ns - s.start_ns) / 1e3,
                       'args': {'frame': s.frame, **s.attrs}})
    with open(path, 'w') as f:
        json.dump(trace, f)


def is_kernel(e) -> bool:
    """A CUDA kernel or copy event of the profiler. The profiler also mirrors
    ``record_function`` labels onto the device timeline (``frame_profile``'s
    start with ``cpt/``), and those are not work."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith('cpt/'))


def cuda_spans(events):
    """Sorted (start, end) us of the kernel events."""
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if is_kernel(e))


def busy_us(spans, lo=float('-inf'), hi=float('inf')) -> tuple[float, int]:
    """Union (us) of the kernel intervals that start in [lo, hi), clipped to
    it, and their count."""
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


def categorize_kernel(name: str) -> str:
    """The category of a CUDA kernel, by the name the profiler gives it:
    the port's own kernels (``csrc/``) by name, then PyTorch's gathers and
    scatters (indexing, ``index_select``, ``index_add_``), sorts,
    elementwise kernels, copies and fills, and the rest."""
    n = name.lower()
    if n.startswith(('memcpy', 'memset')):
        return 'memcpy/memset'
    for ours in ('traverse_packet', 'traverse', 'guiding_scatter', 'blur'):
        if ours + '_kernel(' in n:
            return ours
    if 'gather' in n or 'index' in n or 'scatter' in n:
        return 'gather'
    if 'sort' in n:
        return 'sort'
    if 'elementwise' in n:
        return 'elementwise'
    return 'other'


def device_op_shares(run, top: int = 12) -> dict:
    """Run ``run()`` under the profiler and return {category: device ms}
    of the CUDA kernels it launched (:func:`categorize_kernel`), with
    ``'_top_ops'``: the ``top`` kernels by device ms, ``'_kernels'``: every
    (kernel, ms) in launch order, and ``'_busy_ms'``: the union of the
    kernel intervals. Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError('device_op_shares needs a CUDA device')
    with profile(activities=_activities()) as prof:
        run()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if is_kernel(e)),
                    key=lambda e: e.time_range.start)
    kernels = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
               for e in events]
    by_name, cat_ms = defaultdict(float), defaultdict(float)
    for name, ms in kernels:
        by_name[name] += ms
        cat_ms[categorize_kernel(name)] += ms
    out = dict(cat_ms)
    out['_top_ops'] = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out['_kernels'] = kernels
    out['_busy_ms'] = busy_us(cuda_spans(events))[0] / 1e3
    return out
