#!/usr/bin/env python3
"""Read the two ends the limits in ``portbench/checks/<cell>.json`` are set
between, on the card at the cell's own size, in one process:

* the lower reading: the program, driven through the cell's own loop (its
  warm-up and ``compare_ticks`` ticks), against the plain reference, on
  every seed;
* the upper reading: the control, the plain reference with every traced
  ray rounded to bfloat16 in the program's place, against the plain
  reference, on the first ``--control`` seeds.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --control 3

Prints one JSON line per seed with both readings and the reference's
seconds. The benchmark's own runs never run this.
"""
import argparse
import gc
import json
import os
import sys
import time
from types import SimpleNamespace

if __name__ == '__main__':
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root


def main() -> int:
    from portbench.lib import driver, spec
    from portbench.lib.traffic import load_loop, seeded_camera
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control', type=int, default=3)
    args = ap.parse_args()
    cell = spec.cell(args.workload)
    config, mix = cell['config'], cell['mix']
    os.environ.update({k: str(v) for k, v in config.get('env', {}).items()})
    import torch
    if not torch.cuda.is_available():
        print('calibrate: no CUDA device', file=sys.stderr)
        return 3
    dev = torch.device('cuda', 0)
    pm = driver.program_modules()
    driver.check_config(pm, config)
    lp = load_loop(mix['loop'])
    scene = pm.builder.get_scene(config['scene'])
    for n, seed in enumerate(int(s) for s in args.seeds.split(',')):
        ctx = SimpleNamespace(pm=pm, scene=scene, config=config, mix=mix,
                              seed=seed, device=dev,
                              camera=seeded_camera(config, mix, seed))
        loop = lp.Loop(ctx)
        loop.warm_up()
        for i in range(int(mix.get('compare_ticks', 3))):
            loop.tick(i)
        got = loop.answers()
        del loop
        gc.collect()
        r0 = time.perf_counter()
        want = lp.reference(ctx, got)
        r1 = time.perf_counter()
        out = dict(workload=args.workload, seed=seed,
                   program=lp.compare(got, want), reference_s=r1 - r0,
                   plain_on_cuda=sum(pm.kernels.PLAIN_ON_CUDA.values()))
        if n < args.control:
            out['control'] = lp.compare(lp.reference(ctx, got, control=True),
                                        want)
            out['control_s'] = time.perf_counter() - r1
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
