"""A CPU check of the benchmark's own arithmetic on synthetic inputs: the
percentile over ticks, the busy union, the roofline bound, a traversal's
bytes and operations, the breakdown, every metric reader, the frame
numbers and their judgement, and that ``BENCHMARK.json`` finds a file for
every piece it names. It measures
nothing and needs no card:

    python3 portbench/selftest.py        (or: python3 -m pytest portbench/selftest.py)
"""
from __future__ import annotations

import os
import re
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from portbench.lib import check, spec, stats, timing, trace, work  # noqa: E402
from portbench.lib.traffic import load_loop  # noqa: E402

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def close(a, b, rel=1e-12):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


def test_percentile():
    vals = [float(v) for v in range(1, 101)]
    assert close(stats.percentile(vals, 90),
                 statistics.quantiles(vals, n=100, method='inclusive')[89])
    assert close(stats.percentile(vals, 90), 90.1)
    assert stats.percentile([7.0], 90) == 7.0


def test_busy_union():
    spans = [(0.0, 10.0), (5.0, 12.0), (20.0, 25.0), (21.0, 22.0), (30.0, 40.0)]
    assert trace.busy_us(spans) == (27.0, 5)
    # clipped to [lo, hi): the interval starting at 30 is cut at 35
    assert trace.busy_us(spans, lo=20.0, hi=35.0) == (10.0, 3)


def test_bound():
    ms, by = timing.bound(3.35e9, 1.0)
    assert by == 'bytes' and close(ms, 1.0)
    ms, by = timing.bound(1.0, 67e9)
    assert by == 'operations' and close(ms, 1.0)


def test_traversal_work():
    class Mask(list):
        def sum(self):
            return sum(self)
    st = {'inner': 10, 'leaf': 4, 'rows': Mask([1, 0, 1, 1])}
    n_bytes, n_ops = work.traversal_work(100, 17, st)
    assert n_bytes == 100 * 30 + 100 * 17 + 3 * 512
    assert n_ops == 10 * work.SLAB_OPS + 4 * work.LEAF_OPS


def test_breakdown():
    ev = [('k_a<float>(x)', 0.0, 10.0), ('Memset (Device)', 10.0, 11.0),
          ('k_b', 30.0, 40.0), ('k_a<float>(x)', 45.0, 50.0)]
    b = trace.breakdown(ev)
    ops = dict(b['device_ops'])
    assert close(ops['k_a'], 15e-6) and close(ops['k_b'], 10e-6)
    gaps = dict(b['idle_gaps'])
    assert close(gaps['host issue before k_b'], 19e-6)
    assert close(gaps['host issue before k_a'], 5e-6)


def record(**kw) -> dict:
    ev = [('traverse_kernel(x)', 0.0, 100.0),
          ('void at::native::vectorized_gather_kernel<>', 150.0, 250.0),
          ('Memcpy DtoH', 300.0, 310.0),
          ('void at::native::elementwise_kernel<>', 400.0, 500.0)]
    rec = dict(kind='frames', setup_s=12.5, scene_build_s=2.5, window_s=0.001,
               ticks=2, tick_s=[0.1, 0.3], display_s=[0.002, 0.004],
               events=ev, waves=[dict(bound_ms=0.01, kernel_ms=0.1),
                                 dict(bound_ms=0.02, kernel_ms=0.2)],
               busy_s=None)
    rec.update(kw)
    return rec


def test_readers():
    read = spec.reader
    frames, other = record(), record(kind='samples')
    assert close(read('frame_ms_p90')(frames),
                 stats.percentile([0.1, 0.3], 90) * 1e3)
    assert read('frame_ms_p90')(other) is None
    assert read('setup_s')(frames) == 12.5
    assert read('scene_build_s')(other) == 2.5
    # busy union 100 + 100 + 10 + 100 = 310 us of a 1000 us window
    assert close(read('idle_share.frame')(frames), 69.0)
    assert read('idle_share.frame')(other) is None
    assert read('idle_share.frame')(record(events=None)) is None
    # three kernels (the copy is not one) over two ticks
    assert read('kernels_per_frame')(frames) == 1.5
    assert read('kernels_per_frame')(record(events=None)) is None
    assert close(read('traverse_roofline.frame')(frames), 10.0)
    assert read('traverse_roofline.frame')(record(waves=[])) is None
    assert close(read('display_ms')(frames), 3.0)
    assert read('display_ms')(record(display_s=[])) is None


def test_frame_numbers():
    a = np.zeros((4, 5, 3), np.uint8)
    b = a.copy()
    b[0, 0] = (1, 1, 1)          # one level: rounding, not off
    b[1, 1, 2] = 9               # off by nine levels
    n = check.compare_frames([a, a], [b, b])
    assert close(n['px_off'], 2 / 40)
    assert close(n['mean_gap'], 2 * (3 + 9) / 120)
    assert check.compare_frames([], [])['px_off'] == 1.0
    assert check.compare_frames([a], [b[:2]])['px_off'] == 1.0
    ok, out = check.judge({'px_off': 0.0, 'x': 1.0}, {'px_off': 0.0})
    assert not ok and out['x']['limit'] is None
    assert check.judge({'px_off': 0.0}, {'px_off': 0.0})[0]


def test_benchmark_names_its_pieces():
    bench = spec.benchmark()
    e2e = {m['name'] for m in bench['end_to_end']}
    assert 'setup_s' in e2e
    metrics = bench['end_to_end'] + bench['per_layer']
    names = [m['name'] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m['name']) and UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')
        spec.reader(m['name'])
    for m in bench['per_layer']:
        assert m['moves'] in e2e
    for c in bench['configs']:
        assert NAME.match(c['name']) and os.path.exists(os.path.join(ROOT, c['file']))
    for w in bench['workloads']:
        assert NAME.match(w['name']) and len(w['why']) <= 200
        cell = spec.cell(w['name'])
        reported = {m['name'] for m in cell['end_to_end']}
        assert 'setup_s' in reported and len(reported) >= 2, w['name']
        assert cell['per_layer'], w['name']
        assert cell['config']['chips'] == w['chips']
        loop = load_loop(cell['mix']['loop'])
        assert all(hasattr(loop, k) for k in ('Loop', 'reference', 'compare'))


def main() -> int:
    tests = [v for k, v in sorted(globals().items()) if k.startswith('test_')]
    for t in tests:
        t()
        print(f'ok {t.__name__}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
