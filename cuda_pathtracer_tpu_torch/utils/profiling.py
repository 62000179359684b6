"""Profiling and observability (counterpart of
``cuda_pathtracer_tpu/utils/profiling.py``).

The reference's observability is printf: an FPS EMA every 60 ticks
(src/main.cpp:416-418) and BVH-build wall times (src/bvhBuilder.h:37,264).
Here: a stage timer whose fence waits for the device, the FPS EMA, a
``torch.profiler`` trace written to a directory, and the device time of a
run by kernel category, read from the profiler's CUDA kernels.
``utils/frame_profile.py`` builds its per-band breakdown on the same kernel
events (:func:`is_kernel`, :func:`cuda_spans`, :func:`busy_us`).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile


def _sync(fence) -> None:
    """Wait for the devices of the CUDA tensors in ``fence`` (a tensor, or
    lists, tuples and dicts of them)."""
    if isinstance(fence, torch.Tensor):
        if fence.device.type == 'cuda':
            torch.cuda.synchronize(fence.device)
    elif isinstance(fence, dict):
        for v in fence.values():
            _sync(v)
    elif isinstance(fence, (list, tuple)):
        for v in fence:
            _sync(v)


class StageTimer:
    """Accumulates wall time per named stage; a stage given a ``fence`` waits
    for that work's device, so the numbers mean what they say."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        t0 = time.perf_counter()
        yield
        if fence is not None:
            _sync(fence)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f'{name:30s} {tot * 1e3:9.1f} ms total '
                         f'({tot / n * 1e3:8.2f} ms x {n})')
        return '\n'.join(lines)


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
    directory)."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), 'cpt-torch-trace')
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


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
