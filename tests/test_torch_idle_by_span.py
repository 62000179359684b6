"""``tools/idle_by_span.py``'s reading of a profiled window on the CPU, on
made-up device events and host spans: the card's idle time goes to the
innermost span open on the host at each instant, ``sync.<site>`` spans sum
as ``sync.*``, and idle time with no span open is the loop's own."""
import pytest

from cuda_pathtracer_tpu_torch.tools import idle_by_span as ibs

# device events (name, start, end) us: busy [10, 20), [15, 30), [50, 60)
EVENTS = [('(anonymous namespace)::traverse_kernel(float const*)', 10.0, 20.0),
          ('void (anonymous namespace)::prepass_kernel(int)', 15.0, 30.0),
          ('void at::elementwise_kernel<4>(z)', 50.0, 60.0)]
# host spans, nested: a frame [0, 100) holding a trace [5, 45) with a sync
# [35, 40) inside it, and a sync [70, 80) directly in the frame
SPANS = [('whitted.frame', 0.0, 100.0), ('trace.closest', 5.0, 45.0),
         ('sync.count', 35.0, 40.0), ('sync.div', 70.0, 80.0)]


def test_busy_union_and_idle_gaps():
    busy = ibs.union((a, b) for _, a, b in EVENTS)
    assert busy == [[10.0, 30.0], [50.0, 60.0]]
    assert ibs.idle_intervals(busy, 0.0, 100.0) == [
        (0.0, 10.0), (30.0, 50.0), (60.0, 100.0)]
    assert ibs.idle_intervals(busy, 12.0, 55.0) == [(30.0, 50.0)]


@pytest.mark.parametrize('lo, hi, want', [
    # the window the frame fills: 0-5 frame, 5-10 trace, 30-35 trace,
    # 35-40 sync, 40-45 trace, 45-50 frame, 60-70 frame, 70-80 sync,
    # 80-100 frame
    (0.0, 100.0, {'whitted.frame': 5 + 5 + 10 + 20, 'trace.closest': 15,
                  'sync.*': 15}),
    # a window wider than the spans: the loop's own idle time outside them
    (-10.0, 110.0, {'whitted.frame': 40, 'trace.closest': 15, 'sync.*': 15,
                    ibs.OUTSIDE: 20}),
])
def test_idle_goes_to_the_innermost_open_span(lo, hi, want):
    t = ibs.table(EVENTS, SPANS, lo, hi, frames=1)
    got = {r['span']: r['idle_us'] for r in t['rows']}
    assert got == pytest.approx(want)
    assert t['idle_us'] == pytest.approx(sum(want.values()))
    assert t['busy_us'] == pytest.approx(30.0)
    assert t['window_us'] == hi - lo
    # costliest idle first; host time and openings a frame per name
    assert [r['span'] for r in t['rows']] == sorted(
        got, key=lambda k: -got[k])
    rows = {r['span']: r for r in t['rows']}
    assert rows['sync.*']['a_frame'] == 2
    assert rows['sync.*']['host_ms_a_frame'] == pytest.approx(0.015)
    assert rows['whitted.frame']['host_ms_a_frame'] == pytest.approx(0.1)


def test_report_and_op_names():
    t = ibs.table(EVENTS, SPANS, 0.0, 100.0, frames=2)
    assert t['device_ms_a_frame'] == pytest.approx(
        {'prepass_kernel': 0.0075, 'traverse_kernel': 0.005,
         'at::elementwise_kernel': 0.005})
    text = ibs.report(t)
    assert text.startswith('2 frames in 0.000 s; busy 0.0000 s')
    assert 'whitted.frame: idle 0.0000 s (57.1% of idle)' in text
    assert '3 device ops' not in text and '1.5 device ops a frame' in text
