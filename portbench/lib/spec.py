"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root
names the cell, its configuration and its metrics; the configuration is
``portbench/configs/<config>.json``, the traffic mix
``portbench/traffic/<traffic>.json`` (whose loop is
``portbench/loops/<loop>.py``), the limits of the comparison
``portbench/checks/<workload>.json`` and each metric's reader
``portbench/metrics/<metric>.py``. Adding a cell is adding files and
entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(ValueError):
    """A cell, configuration, mix, limit file or reader that is missing or
    malformed."""


def _load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f'missing {os.path.relpath(path, ROOT)}') from None


def benchmark() -> dict:
    return _load_json(os.path.join(ROOT, 'BENCHMARK.json'))


def cell(name: str) -> dict:
    """The cell ``name`` with everything it names: ``workload`` (the
    BENCHMARK.json entry), ``config``, ``mix``, ``limits``, ``end_to_end``
    and ``per_layer`` (the metric entries this cell reports)."""
    bench = benchmark()
    work = {w['name']: w for w in bench['workloads']}
    if name not in work:
        raise SpecError(f'no workload {name!r} in BENCHMARK.json '
                        f'(have: {", ".join(sorted(work))})')
    w = work[name]

    def for_cell(metrics):
        return [m for m in metrics
                if 'workloads' not in m or name in m['workloads']]
    config = _load_json(os.path.join(BENCH_DIR, 'configs',
                                     w['config'] + '.json'))
    mix = _load_json(os.path.join(BENCH_DIR, 'traffic', w['traffic'] + '.json'))
    limits = _load_json(os.path.join(BENCH_DIR, 'checks', name + '.json'))
    return dict(workload=w, config=config, mix=mix, limits=limits,
                end_to_end=for_cell(bench['end_to_end']),
                per_layer=for_cell(bench['per_layer']))


def reader(metric: str):
    """The ``read(record)`` function of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(BENCH_DIR, 'metrics', metric + '.py')
    if not os.path.exists(path):
        raise SpecError(f'no reader portbench/metrics/{metric}.py')
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + metric.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
