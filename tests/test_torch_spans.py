"""The port's span recorder (``utils/profiling.py``): off by default, the
spans of one Whitted frame of ``_torch_room.py``'s glass room at 64x48
(every level has lanes there), the set-up spans, the recorder turned on by
a ``torch.profiler`` profile with its stamps on the clock of the profile's
events, the spans in ``device_trace``'s ``trace.json``, and the benchmark's
five span readers (``portbench/metrics/``) on synthetic spans.

Marked ``cuda`` and skipped without a card: every wait of the host for the
card in a frame falls inside a ``sync.*`` span (the warnings of
``torch.cuda.set_sync_debug_mode``), and a span that closes after
``torch.cuda.synchronize()`` ends after its kernel on the profile's clock.
Imports no JAX, so the card runs it with ``--noconftest``.
"""
import json
import os
import sys
import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from _torch_room import GLASS_CAMERA, build_glass_room  # noqa: E402
from cuda_pathtracer_tpu_torch.core.camera import Camera  # noqa: E402
from cuda_pathtracer_tpu_torch.models import film  # noqa: E402
from cuda_pathtracer_tpu_torch.models.raytracer import Raytracer  # noqa: E402
from cuda_pathtracer_tpu_torch.scene import scene as scene_mod  # noqa: E402
from cuda_pathtracer_tpu_torch.scene.builder import add_cube  # noqa: E402
from cuda_pathtracer_tpu_torch.utils import profiling  # noqa: E402
from portbench.lib import spec  # noqa: E402

W, H = 64, 48


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.fixture
def recorder():
    profiling.clear()
    yield profiling
    profiling.clear()


def _room(device='cpu'):
    eng = Raytracer(build_glass_room(scene_mod, add_cube), W, H,
                    device=device)
    return eng, Camera.create(**GLASS_CAMERA, device=device)


def _tick(eng, cam, stats=None):
    eng.render(cam, stats=stats)
    eng.finish()
    return film.to_uint8(eng.image())


def test_recorder_is_off_by_default(recorder):
    eng, cam = _room()
    n = len(recorder.spans())
    assert recorder.span('a') is recorder.span('b')
    with recorder.span('whitted.frame', new_frame=True) as sp:
        assert sp is None
    _tick(eng, cam)
    assert len(recorder.spans()) == n


def test_whitted_frame_spans(recorder):
    eng, cam = _room()
    stats = []
    with recorder.record() as got:
        _tick(eng, cam, stats)
    assert got and all(s.end_ns is not None for s in got)
    by_id = {s.id: s for s in got}
    frames = [s for s in got if s.name == 'whitted.frame']
    assert len(frames) == 1 and frames[0].parent is None
    levels = [s for s in got if s.name == 'whitted.level']
    assert [s.parent for s in levels] == [frames[0].id] * 7
    assert [s.attrs['depth'] for s in levels] == list(range(7))
    assert [s.attrs['lanes'] for s in levels] == [s['active'] for s in stats]
    assert [s.attrs['dropped'] for s in levels] == \
        [s['dropped'] for s in stats]
    assert max(s['dropped'] for s in stats) > 0     # the cap cut a level
    assert all(s['active'] for s in stats)
    compact = [s for s in got if s.name == 'sync.compact']
    assert len(compact) == 6
    for s in compact:
        assert by_id[s.parent].name == 'whitted.compact'
        assert by_id[by_id[s.parent].parent].name == 'whitted.level'
    assert sum(s.name == 'trace.closest' for s in got) == 7
    assert sum(s.name == 'trace.shadow' for s in got) == 7   # one light
    names = {s.name for s in got}
    assert {'whitted.rays', 'film.display', 'film.to_host',
            'sync.to_host'} <= names
    # one frame id, and every span inside its parent
    assert {s.frame for s in got} == {frames[0].frame}
    for s in got:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # siblings do not overlap
    kids = {}
    for s in got:
        kids.setdefault(s.parent, []).append(s)
    for sib in kids.values():
        sib.sort(key=lambda s: s.start_ns)
        assert all(a.end_ns <= b.start_ns for a, b in zip(sib, sib[1:]))
    # the next frame has the next id; nothing records after record()
    with recorder.record() as again:
        eng.render(cam)
    assert {s.frame for s in again} == {frames[0].frame + 1}
    n = len(recorder.spans())
    _tick(eng, cam)
    assert len(recorder.spans()) == n


def test_setup_spans_always_record(recorder):
    eng, _ = _room()
    got = recorder.spans()
    models = [s for s in got if s.name == 'scene.models']
    assert len(models) == 7                 # the cube and six walls
    assert sum(s.attrs['triangles'] for s in models) == 12 + 6 * 8
    by_id = {s.id: s for s in got}
    init = [s for s in got if s.name == 'engine.init']
    assert len(init) == 1
    for name in ('scene.to_device', 'scene.world'):
        inner = [s for s in got if s.name == name]
        assert len(inner) == 1 and by_id[inner[0].parent] is init[0]


def test_fenced_record_and_the_clock(recorder):
    with recorder.record(fence=True) as got:
        with recorder.span('outer'):
            a = time.time_ns()
            with recorder.span('inner'):
                torch.ones(8).sum()
            b = time.time_ns()
    outer, inner = got
    assert inner.parent == outer.id
    assert outer.start_ns <= a <= inner.start_ns <= inner.end_ns <= b \
        <= outer.end_ns


def test_profile_turns_the_recorder_on(recorder):
    """Under a CPU-only profile the recorder records by itself; a
    ``record_function`` range opened inside a span lies inside it on the
    profile's clock, and recording stops with the profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with recorder.span(f'outer{i}') as sp:
                assert sp is not None
                with record_function(f'cpt_clock{i}'):
                    torch.ones(64).sum()
    assert recorder.span('after') is profiling._NO_SPAN
    spans = {s.name: s for s in recorder.spans()}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith('cpt_clock')]
    assert len(events) == 5
    for e in events:
        s = spans['outer' + e.name()[len('cpt_clock'):]]
        start = e.start_ns()
        assert s.start_ns <= start <= start + e.duration_ns() <= s.end_ns


def test_device_trace_carries_the_spans(recorder, tmp_path):
    with profiling.device_trace(str(tmp_path)) as d:
        with recorder.span('film.display'):
            torch.ones(64).sum()
    with open(os.path.join(d, 'trace.json')) as f:
        trace = json.load(f)
    track = [e for e in trace['traceEvents']
             if e.get('tid') == profiling.SPAN_TID and e.get('ph') == 'X']
    assert [e['name'] for e in track] == ['film.display']
    s = recorder.spans()[-1]
    base = trace.get('baseTimeNanoseconds', 0)
    assert abs(track[0]['ts'] - (s.start_ns - base) / 1e3) < 1e-3
    assert track[0]['args']['frame'] == s.frame


# ---------------------------------------------------- the benchmark's readers

def _span(i, name, start_us, end_us, parent=None, frame=1):
    s = profiling.Span(name, False)
    s.id, s.parent, s.frame = i, parent, frame
    s.start_ns, s.end_ns = int(start_us * 1e3), int(end_us * 1e3)
    return s


def _two_frames():
    """Two frames of one level each, with a compaction sync inside the
    level, a finish sync outside it, and a set-up span."""
    out = [_span(0, 'scene.world', 0, 2_000_000, frame=0)]
    for f, t0 in ((1, 10_000_000), (2, 10_100_000)):
        i = len(out)
        out += [_span(i, 'whitted.frame', t0, t0 + 60, frame=f),
                _span(i + 1, 'whitted.level', t0 + 10, t0 + 50, i, f),
                _span(i + 2, 'whitted.compact', t0 + 30, t0 + 45, i + 1, f),
                _span(i + 3, 'sync.compact', t0 + 35, t0 + 40, i + 2, f),
                _span(i + 4, 'sync.finish', t0 + 60, t0 + 70, None, f)]
    return out


def test_span_readers(monkeypatch):
    read = spec.reader
    monkeypatch.setattr(profiling, 'spans', _two_frames)
    # 40 us of level less 5 of its sync, per frame
    assert read('levels_host_ms')({}) == pytest.approx(0.035)
    assert read('sync_wait_ms')({}) == pytest.approx(0.015)
    assert read('syncs_per_frame')({}) == 2.0
    assert read('world_tables_s')({}) == pytest.approx(2.0)
    # level 1 covers [10, 35) and [40, 50) past 10 s; a kernel at [20, 30)
    # and one at [45, 60): 35 - 10 - 5 = 20 us idle; level 2 all idle, 35
    events = [('k', 10_000_020.0, 10_000_030.0),
              ('k', 10_000_045.0, 10_000_060.0)]
    rec = dict(kind='frames', events=events, window_s=1e-3)
    assert read('idle_share.levels')(rec) == pytest.approx(100.0 * 55 / 1e3)
    assert read('idle_share.levels')(dict(rec, events=None)) is None
    assert read('idle_share.levels')(dict(rec, kind='samples')) is None


def test_span_readers_without_spans(monkeypatch):
    read = spec.reader
    rec = dict(kind='frames', events=[], window_s=1.0)
    names = ('levels_host_ms', 'sync_wait_ms', 'syncs_per_frame',
             'idle_share.levels', 'world_tables_s')
    monkeypatch.setattr(profiling, 'spans', list)
    assert [read(n)(rec) for n in names] == [None] * 5
    # a program without the recorder, as before it had one
    monkeypatch.delattr(profiling, 'spans')
    assert [read(n)(rec) for n in names] == [None] * 5


# ------------------------------------------------------------------ the card

@pytest.mark.cuda
def test_every_card_wait_is_a_sync_span(card, recorder):
    """Each warning of ``set_sync_debug_mode('warn')`` over a frame, its
    display and its copy to the host comes while a ``sync.*`` span is the
    innermost one open, and the ``sync.*`` spans number the warnings, less
    ``finish``'s explicit ``torch.cuda.synchronize()``, which does not
    warn, and the compactions' read-backs (``sync.compact``), which wait
    in the kernel library's own stream synchronize, out of PyTorch's
    sight."""
    eng, cam = _room('cuda')
    _tick(eng, cam)
    torch.cuda.synchronize()
    inside = []

    def show(message, category, filename, lineno, file=None, line=None):
        if 'synchronizing' in str(message):    # not the mode's own notice
            inside.append(profiling._OPEN[-1].name if profiling._OPEN
                          else None)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        torch.cuda.set_sync_debug_mode('warn')
    try:
        with recorder.record() as got, warnings.catch_warnings():
            warnings.simplefilter('always')
            warnings.showwarning = show
            _tick(eng, cam)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [s.name for s in got if s.name.startswith('sync.')]
    assert inside and all(n is not None and n.startswith('sync.')
                          for n in inside), inside
    assert sorted(inside) == sorted(
        n for n in syncs if n not in ('sync.finish', 'sync.compact'))
    assert syncs.count('sync.finish') == 1
    assert syncs.count('sync.compact') == 6


@pytest.mark.cuda
def test_span_closes_after_its_kernel_on_the_profile_clock(card, recorder):
    """Under a CUDA-only profile, a span that closes after
    ``torch.cuda.synchronize()`` ends after its kernel's device interval,
    and starts before it."""
    a = torch.randn(2048, 2048, device='cuda')
    (a @ a).sum().item()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(5):
            with recorder.span(f'matmul{i}'):
                a @ a
                torch.cuda.synchronize()
    got = [s for s in recorder.spans() if s.name.startswith('matmul')]
    device = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if str(e.device_type()).split('.')[-1] == 'CUDA')
    assert len(got) == 5 and device, device
    for s in got:
        inside = [(a, b) for a, b, _ in device
                  if s.start_ns <= a < b <= s.end_ns]
        assert inside, (s.start_ns, s.end_ns, device)
    # every device event of the profile falls in one of the spans
    for a, b, name in device:
        assert any(s.start_ns <= a < b <= s.end_ns for s in got), \
            (name, a, b, [(s.start_ns, s.end_ns) for s in got])
