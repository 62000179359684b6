"""One run of one cell: set-up, the measured window, the traced records, the
comparison with the reference and the result line. What belongs to one
kind of traffic (its engine, ticks, answers, reference and comparison)
lives in its loop, ``portbench/loops/<loop>.py`` (``lib/traffic.py``)."""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from types import SimpleNamespace

from . import spec as spec_mod
from .check import judge
from .stats import percentile
from .trace import WaveRecorder, breakdown, busy_us, device_profile, wave_rooflines
from .traffic import load_loop, seeded_camera

# the longest traced window: the profiler's records of a longer one take
# minutes to read
TRACE_SECONDS = 10.0


def parse(argv):
    ap = argparse.ArgumentParser(prog='portbench/run.py', description=(
        'Run one cell of BENCHMARK.json once and print its result line.'))
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(msg: str):
    print(msg, file=sys.stderr, flush=True)


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        cell = spec_mod.cell(args.workload)
    except spec_mod.SpecError as e:
        say(f'portbench: {e}')
        return 2
    chips = int(cell['workload']['chips'])
    os.environ.update({k: str(v) for k, v in cell['config'].get('env', {}).items()})
    import torch
    if not torch.cuda.is_available():
        say('portbench: no CUDA device; the benchmark runs on a card only')
        return 3
    if torch.cuda.device_count() < chips:
        say(f'portbench: {args.workload} needs {chips} cards, '
            f'{torch.cuda.device_count()} visible')
        return 3
    if chips > 1:
        say(f'portbench: {args.workload} asks for {chips} cards; this harness '
            f'runs cells on one')
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device('cuda', 0), t0)
    emit(result)
    return 0


def emit(result: dict):
    """The checks as the last lines of standard error, then the result as
    the last line of standard output (``checks`` its last key)."""
    for name, c in result['checks'].items():
        say(f'check {name} {c["value"]!r} limit {c["limit"]!r}')
    say(f'correct {result["correct"]}')
    print(json.dumps(result), flush=True)


# ---------------------------------------------------------------- one run

def program_modules():
    from cuda_pathtracer_tpu_torch.core import camera
    from cuda_pathtracer_tpu_torch.models import film, raytracer
    from cuda_pathtracer_tpu_torch.ops import dispatch, kernels
    from cuda_pathtracer_tpu_torch.ops import traverse_packet2
    from cuda_pathtracer_tpu_torch.scene import builder
    return SimpleNamespace(camera=camera, film=film, raytracer=raytracer,
                           dispatch=dispatch, kernels=kernels,
                           traverse_packet2=traverse_packet2, builder=builder)


def check_config(pm, config: dict):
    """Refuse a program that departs from what the configuration states
    where the program has no option for it."""
    v1 = bool(int(config.get('env', {}).get('CPT_PACKET_V1', '0')))
    if pm.dispatch.PACKET_V1 != v1:
        raise ValueError('the program\'s traversal route is not the '
                         'configuration\'s (CPT_PACKET_V1 read at import)')


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t0: float) -> dict:
    """One run on ``device``: set-up, the window, the records and the
    comparison. Returns the result dict."""
    import torch
    config, mix = cell['config'], cell['mix']
    pm = program_modules()
    check_config(pm, config)
    lp = load_loop(mix['loop'])
    if device.type == 'cuda':
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)   # the allocator, before its peak resets
        torch.cuda.reset_peak_memory_stats(device)

    b0 = time.perf_counter()
    scene = pm.builder.get_scene(config['scene'])
    ctx = SimpleNamespace(pm=pm, scene=scene, config=config, mix=mix,
                          seed=seed, device=device,
                          camera=seeded_camera(config, mix, seed))
    loop = lp.Loop(ctx)
    sync(device)
    scene_build_s = time.perf_counter() - b0
    loop.warm_up()
    sync(device)
    setup_s = time.time() - t0

    window = min(seconds, TRACE_SECONDS) if trace else seconds
    ticks, failed, bad_ticks = [], 0, 0
    waves = getattr(lp, 'WAVES', ()) if trace else ()
    with WaveRecorder(pm.dispatch, waves) as rec, \
            device_profile(trace and device.type == 'cuda') as prof:
        sync(device)
        w0 = time.perf_counter()
        i = 0
        while True:
            rec.armed = i == 0
            try:
                r = loop.tick(i)
            except Exception as e:  # noqa: BLE001 - a tick that raises is failed
                say(f'tick {i} raised {type(e).__name__}: {e}')
                failed += 1
                r = None
            rec.armed = False
            if r is not None:
                bad_ticks += bool(r['bad'])
                ticks.append(r)
            i += 1
            if time.perf_counter() - w0 >= window or (failed >= 3 and not ticks):
                break
        sync(device)
        window_s = time.perf_counter() - w0
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == 'cuda' else 0)
    plain = sum(pm.kernels.PLAIN_ON_CUDA.values())
    launches = {k: v for k, v in pm.kernels.LAUNCHES.items() if v}
    events = prof['events']
    wave_recs = []
    if rec.saved and device.type == 'cuda':
        from .walk import walk
        wave_recs = wave_rooflines(rec.saved,
                                   pm.traverse_packet2.traverse_merged, walk)
    busy_s = (busy_us([(s, e) for _, s, e in events])[0] / 1e6
              if events is not None else None)
    record = dict(setup_s=setup_s, scene_build_s=scene_build_s,
                  window_s=window_s, ticks=len(ticks),
                  tick_s=[t['seconds'] for t in ticks], events=events,
                  waves=wave_recs, busy_s=busy_s)
    for key in sorted({k for t in ticks for k in t} - {'seconds', 'bad'}):
        record[key] = [t[key] for t in ticks if key in t]
    record.update(loop.record())
    got = loop.answers()
    # the program's state goes before the reference runs
    del loop, scene, rec
    ctx.scene = None
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    tick_ms = sorted(t['seconds'] * 1e3 for t in ticks) or [0.0]
    say(f'tick ms: min {tick_ms[0]:.1f} median {tick_ms[len(tick_ms) // 2]:.1f}'
        f' max {tick_ms[-1]:.1f}')
    if len(ticks) >= 30:
        # whether the pace drifts within the window or is set per process
        k = len(ticks) // 3
        thirds = [percentile([t['seconds'] * 1e3 for t in part], 90)
                  for part in (ticks[:k], ticks[k:2 * k], ticks[2 * k:])]
        say('tick ms p90 by thirds of the window: '
            + ' '.join(f'{v:.2f}' for v in thirds))
    say(f'window: {len(ticks)} ticks in {window_s:.3f} s, set-up '
        f'{setup_s:.3f} s (scene and engine {scene_build_s:.3f} s), '
        f'launches {launches}')
    r0 = time.perf_counter()
    want = lp.reference(ctx, got)
    say(f'reference: {time.perf_counter() - r0:.3f} s')
    numbers = lp.compare(got, want)
    numbers['plain_on_cuda'] = float(plain)
    correct, checks = judge(numbers, cell['limits'])

    metrics = {}
    for m in (cell['per_layer'] if trace else cell['end_to_end']):
        v = spec_mod.reader(m['name'])(record)
        if v is not None:
            metrics[m['name']] = {'value': v, 'unit': m['unit']}
    dev = dict(platform='gpu' if device.type == 'cuda' else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == 'cuda' else 'cpu'),
               count=1, memory_peak_bytes=int(mem_peak),
               card=card_line_safe(device))
    if trace:
        dev['busy_s'] = busy_s
        dev['window_s'] = window_s
    out = dict(correct=bool(correct and failed == 0 and ticks),
               attempted=len(ticks) + failed - bad_ticks, failed=failed,
               metrics=metrics, device=dev)
    if trace and events is not None:
        out['breakdown'] = breakdown(events)
    out['checks'] = checks
    return out


def sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def card_line_safe(device) -> str:
    if device.type != 'cuda':
        return ''
    from .timing import card_line
    return card_line()
