"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the twelve hand-written CUDA kernels from ``cuda_pathtracer_tpu_torch/
csrc`` and drives the port's two render paths once at full size, then the
four probe kernels' sweeps:

1. the converge path: the sibenik scene at 1920x1080, one clear frame, 4
   converge samples (32 bounces, NEE, guiding training) and the blurred
   display image, on the v2 merged-table traversal, in the engine's default
   schedule: 5 bands of 216 rows in tile lane order, each band's bounces
   from 3 on narrowed to the live lanes in buffers of 51,840 (level 1) and
   12,960 lanes (level 2). Every converge sample must take both levels, and
   ``traverse`` must run on waves of both widths. Then two converge samples
   are timed with the frame as one band (buffers of 259,200 and 64,800);
2. the CLI's animated path: ``python -m cuda_pathtracer_tpu_torch --scene
   outside --width 1920 --height 1080 --time 5 --spp 4 --blur``, run in this
   process with ``PACKET_V1`` on (the split-table v1 traversal, shading's
   re-intersect, the device refit of the moved cubes), then again with it
   off (v2 on the refit-derived merged table), the two renders compared.

Each path's launch counts are set to 0 just before it and read just after:
every kernel of a path must have launched on it, and no plain PyTorch version
may have run on the card. Then each kernel is held against its plain version
on the main path's own inputs: v2 traversal on the primary, shadow, bounce-1
and first level-1 tail waves of the first band of sibenik's first converge
sample (found, t and gid bit-identical, u, v within 1e-6), the v1 traversal
on the same waves (against its plain version found, t and gid bit-identical;
against v2 found equal, and t equal but on exact ties between two triangles),
each wave also timed with no ray live (the launch floor), with its visits per
live ray and the kernel's share of its bound; the guiding scatter on that
band's updates (rtol 1e-5), the blur on the final 1920x1080 accumulators in
pixel order (bit for bit). The refitted outside tables are held to a forced
full rebuild on the card (atol 2e-4, NaN slots equal), and two small rooms
render alike on the card and on the CPU: 64x48 below the tail gate, and 64x64
in 2 bands of 2,048 lanes with the gate lowered to 2,048 (equal ``rand_idx``
after every frame). Kernel and plain times come from CUDA events, behind a
sleep kernel that lets the host queue every launch first (device time, not
the wrapper's host time); each kernel's bound is the larger of its bytes over
3.35 TB/s and its FP32 operations over 67 TFLOP/s, counted from this run's
inputs (for the traversals, the node and leaf visits of the plain walks).

3. the ``tools`` probes (``cuda_pathtracer_tpu_torch/tools/``), the Hopper
   counterparts of all 23 Pallas sites under the repo's ``tools/``: each
   module's ``probe`` runs the TPU probe's own sweep through its kernel
   (row gathers, the bf16 slab chain, the scripted packet step, the one-hot
   fetch; then the TPU packet step, the decision round trip, the visit
   anatomy and the v1 packet-walk lab on sibenik's waves) with the counts
   set to 0 just before; every case is then held to its plain version bit
   for bit (digests of the decision words included), and one answer line
   per probe is printed with its Hopper question's table (dependent row
   reads by table size, SASS counts, ns per step, visit or packet-step,
   the walk beside the port's traversals on the same rays).

Prints the card's name and power limit, the build time, per-phase lines,
then one JSON line of per-kernel results, the card line, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line, when
there is no CUDA device or any phase fails. Imports nothing of JAX or of the
JAX package.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

from cuda_pathtracer_tpu_torch.tools.timing import bound, card_line, cuda_ms

KERNELS = {
    'traverse': ('cuda_pathtracer_tpu_torch/csrc/traverse.cu',
                 'cuda_pathtracer_tpu/ops/traverse_packet2.py:289'),
    'guiding_scatter': ('cuda_pathtracer_tpu_torch/csrc/guiding_scatter.cu',
                        'cuda_pathtracer_tpu/ops/guiding_scatter.py:47'),
    'blur': ('cuda_pathtracer_tpu_torch/csrc/blur.cu',
             'cuda_pathtracer_tpu/ops/blur_pallas.py:40'),
    'traverse_packet': ('cuda_pathtracer_tpu_torch/csrc/traverse_packet.cu',
                        'cuda_pathtracer_tpu/ops/traverse_packet.py:180'),
    'probe_gather': ('cuda_pathtracer_tpu_torch/csrc/probe_gather.cu',
                     'tools/pallas_gather_probe1.py:16, '
                     'tools/pallas_gather_probe2.py:12, '
                     'tools/pallas_gather_probe2.py:27, '
                     'tools/pallas_gather_probe3.py:12, '
                     'tools/pallas_probe_r2a.py:10, tools/pallas_probe_r2f.py:18'),
    'probe_slab': ('cuda_pathtracer_tpu_torch/csrc/probe_slab.cu',
                   'tools/bf16_vpu_probe.py:56'),
    'probe_step': ('cuda_pathtracer_tpu_torch/csrc/probe_step.cu',
                   'tools/pallas_probe_r2b.py:49, tools/pallas_probe_r2c.py:63, '
                   'tools/pallas_probe_r2d.py:52, tools/pallas_probe_r2e.py:62'),
    'probe_onehot': ('cuda_pathtracer_tpu_torch/csrc/probe_onehot.cu',
                     'tools/pallas_probe_onehot.py:63, '
                     'tools/pallas_probe_onehot2.py:74, '
                     'tools/pallas_probe_onehot3.py:68'),
    'probe_packet_step': ('cuda_pathtracer_tpu_torch/csrc/probe_packet_step.cu',
                          'tools/pallas_probe_r2f.py:96, '
                          'tools/pallas_probe_r2g.py:158, '
                          'tools/pallas_probe_r2h.py:172, '
                          'tools/pallas_probe_r2i.py:68'),
    'probe_decision': ('cuda_pathtracer_tpu_torch/csrc/probe_decision.cu',
                       'tools/kernel_lab2.py:136, tools/mosaic_bisect.py:166'),
    'probe_visit': ('cuda_pathtracer_tpu_torch/csrc/probe_visit.cu',
                    'tools/kernel_lab3.py:487, tools/subpacket_probe.py:295'),
    'probe_packet_walk': ('cuda_pathtracer_tpu_torch/csrc/probe_packet_walk.cu',
                          'tools/kernel_lab.py:256'),
}
# the kernels each path must launch
SIBENIK_KERNELS = ('traverse', 'guiding_scatter', 'blur')
OUTSIDE_KERNELS = ('traverse_packet', 'blur')
WIDTH, HEIGHT = 1920, 1080
CONVERGE_SAMPLES = 4
OUTSIDE_ARGS = ['--scene', 'outside', '--width', str(WIDTH), '--height',
                str(HEIGHT), '--time', '5', '--spp', '4', '--blur',
                '--device', 'cuda']

# FP32 operations per visit, as the kernels do them: an inner visit slab-tests
# 16 slots (6 mul, 6 sub, 6 min/max, 4 for the tmin/tmax reductions, 1 max,
# 2 compares); a leaf visit runs Moller-Trumbore on 12 triangles (56 each:
# the cross, dot, reciprocal, u/v/t products and the 8 acceptance tests)
SLAB_OPS = 16 * 25
LEAF_OPS = 12 * 56


def log(msg: str):
    print(msg, flush=True)


class Recorder:
    """Wraps a module attribute; keeps clones of the arguments of the calls
    that ``pick(args, kw)`` names (the first call under each name), and with
    ``returns`` the return value of every call, and otherwise passes straight
    through."""

    def __init__(self, module, name: str, pick=None, returns: bool = False):
        self.module, self.name, self.pick = module, name, pick
        self.returns = returns
        self.orig = getattr(module, name)
        self.saved, self.returned = {}, []

    def __enter__(self):
        def wrapped(*args, **kw):
            key = self.pick(args, kw) if self.pick else None
            if key is not None and key not in self.saved:
                self.saved[key] = (
                    tuple(a.clone() if hasattr(a, 'clone') else a for a in args),
                    dict(kw))
            out = self.orig(*args, **kw)
            if self.returns:
                self.returned.append(out)
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def traversal_work(n_rays: int, n_out: int, stats: dict, row_bytes: int = 512):
    """Bytes and operations a traversal needs on this wave: each ray read and
    written once, each table row it touches read once, and the visits the
    plain walk made."""
    rows = sum(int(v.sum()) for k, v in stats.items() if k.endswith('rows'))
    n_bytes = n_rays * (12 + 12 + 4 + 1 + 1) + n_rays * n_out + rows * row_bytes
    n_ops = stats['inner'] * SLAB_OPS + stats['leaf'] * LEAF_OPS
    return n_bytes, n_ops


def run_probes(launches: dict, results: dict, failures: list):
    """Phase 3: each probe module's own sweep through its kernel, with the
    launch counts set to 0 just before it and read just after, then every
    case held to the plain version (bit for bit); fills ``launches`` and
    ``results`` and appends to ``failures``."""
    import torch
    from cuda_pathtracer_tpu_torch.ops import kernels
    from cuda_pathtracer_tpu_torch.tools import (
        bf16_probe, decision_probe, gather_probe, lab_v1_probe, onehot_probe,
        packet_step_probe, step_probe, visit_probe)
    for name, mod in (('probe_gather', gather_probe), ('probe_slab', bf16_probe),
                      ('probe_step', step_probe),
                      ('probe_onehot', onehot_probe),
                      ('probe_packet_step', packet_step_probe),
                      ('probe_decision', decision_probe),
                      ('probe_visit', visit_probe),
                      ('probe_packet_walk', lab_v1_probe)):
        t = time.perf_counter()
        kernels.reset_counts()
        rows = mod.probe('cuda')
        torch.cuda.synchronize()
        launches[name] = kernels.LAUNCHES[name]
        plain = kernels.PLAIN_ON_CUDA[name]
        if launches[name] <= 0:
            failures.append(f'{name}: no launch on its probe sweep')
        if plain:
            failures.append(f'{name}: {plain} plain versions on CUDA in its '
                            f'probe sweep')
        rows = mod.compare(rows)
        bad = [r.get('label', r.get('site')) for r in rows if not r['equal']]
        if bad:
            failures.append(f'{name}: kernel disagrees with plain on {bad}')
        if mod is lab_v1_probe:
            failures += lab_v1_checks(rows)
        if mod is gather_probe:
            lines = [gather_probe.site_line(r) for r in rows]
            lines += gather_probe.hopper_question()
        else:
            lines = mod.hopper_question(rows)
        for line in lines:
            log('  ' + line)
        results[name] = mod.summary(rows)
        log(f'{mod.answer(rows)} | {launches[name]} launches, '
            f'{time.perf_counter() - t:.1f} s')


def lab_v1_checks(rows):
    """The packet-walk lab's own checks: v0, packed and phase give the same
    t ([MATCH]); the walk's t differs from the port's v1 traversal on the
    same rays on at most 0.1% of its hits (exact ties between triangles)."""
    out = []
    for r in rows:
        if r.get('match') is False:
            out.append(f"probe_packet_walk {r['label']}: t differs from v0 "
                       f"([MISMATCH])")
        if r['variant'] == 'v0':
            hits = int(r['out']['out'].view(-1, 4, 128)[:, 2].sum())
            if r['traverse_split_t_diff'] > 0.001 * max(hits, 1):
                out.append(f"probe_packet_walk {r['wave']}: t differs from "
                           f"traverse_split on {r['traverse_split_t_diff']} "
                           f"of {hits} hits")
    return out


def run_cli(main, args, packet_v1: bool):
    """The port's CLI main in this process, with its Pathtracer and scene
    captured. Returns (rc, stderr text, pathtracer, scene)."""
    from cuda_pathtracer_tpu_torch.models import pathtracer as pt_mod
    from cuda_pathtracer_tpu_torch.ops import dispatch as dispatch_mod
    from cuda_pathtracer_tpu_torch.scene import builder
    dispatch_mod.PACKET_V1 = packet_v1
    err = io.StringIO()
    try:
        with Recorder(pt_mod, 'Pathtracer', returns=True) as app, \
                Recorder(builder, 'get_scene', returns=True) as scn, \
                contextlib.redirect_stderr(err):
            rc = main(args)
    finally:
        dispatch_mod.PACKET_V1 = False
    for line in err.getvalue().splitlines():
        if line.startswith(('rendered', 'energy')):
            log('  cli: ' + line)
    return rc, err.getvalue(), app.returned[0], scn.returned[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false)', file=sys.stderr)
        return 1
    # the port must not need JAX: make any attempt to import it fail
    sys.modules['jax'] = None
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cuda_pathtracer_tpu_torch.__main__ import main as cli_main
    from cuda_pathtracer_tpu_torch.accel import native
    from cuda_pathtracer_tpu_torch.core.camera import Camera
    from cuda_pathtracer_tpu_torch.models import guiding as guiding_mod
    from cuda_pathtracer_tpu_torch.constants import MAX_RAY_DEPTH
    from cuda_pathtracer_tpu_torch.models import pathtracer as ptm
    from cuda_pathtracer_tpu_torch.models.pathtracer import (Pathtracer,
                                                             band_geometry)
    from cuda_pathtracer_tpu_torch.ops import blur as blur_mod
    from cuda_pathtracer_tpu_torch.ops import dispatch as dispatch_mod
    from cuda_pathtracer_tpu_torch.ops import guiding_scatter as gs_mod
    from cuda_pathtracer_tpu_torch.ops import kernels
    from cuda_pathtracer_tpu_torch.ops import traverse_packet as tp1
    from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as tp2
    from cuda_pathtracer_tpu_torch.scene import builder
    from cuda_pathtracer_tpu_torch.utils.frame_profile import ScheduleTap

    card = card_line()
    log(f'card: {card} | torch {torch.__version__} cuda {torch.version.cuda}'
        f' | {torch.cuda.get_device_name(0)}')

    t = time.perf_counter()
    so = kernels.build()
    kernels.library()
    log(f'kernel build: {time.perf_counter() - t:.2f} s -> {os.path.relpath(so)}')
    with open(so[:-3] + '.log') as f:
        for line in f:
            if 'registers' in line or 'spill' in line:
                log('  ptxas: ' + line.strip())

    failures = []
    launches = {}

    t = time.perf_counter()
    ok = native.available()
    log(f'native BVH builder: available={ok} (build '
        f'{time.perf_counter() - t:.2f} s); the host BVH builds with '
        f'{"it" if ok else "the numpy fallback"}')
    if not ok:
        for line in native.build_log().splitlines()[-8:]:
            log('  g++: ' + line)

    # ---- path 1: sibenik converge at full size (v2), default bands ----
    t = time.perf_counter()
    scene = builder.get_scene('sibenik')
    pt = Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    torch.cuda.synchronize()
    log(f'scene: sibenik {len(scene._tri_mat)} triangles, merged BVH '
        f'{pt.dyn.packet_merged.shape[0]} rows, split BVH '
        f'{pt.dyn.packet_inner.shape[0]} + {pt.dyn.packet_leaf.shape[0]} rows, '
        f'depth {pt.dyn.depth}; host build + upload '
        f'{time.perf_counter() - t:.2f} s')
    levels = ptm.tail_levels(WIDTH * pt.band_h, MAX_RAY_DEPTH)
    pt_bands = pt.bands
    log(f'schedule: {pt.bands} bands of {pt.band_h} rows, tile order '
        f'{pt.tile_order}, tail levels (start, end, lanes) {levels}')
    if (pt.bands, pt.band_h, pt.tile_order) != (5, 216, True):
        failures.append(f'sibenik: {pt.bands} bands of {pt.band_h} rows, '
                        f'tile order {pt.tile_order}; want 5 of 216, tiled')
    cam = Camera.create([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0,
                        device='cuda')

    # the traversal waves held against the plain versions below: the first
    # band of the first converge sample, its first three trace calls and its
    # first level-1 tail wave
    phase = {'sample': None}
    wave_sizes = set()
    band_calls = []

    def pick_wave(args, kw):
        n = args[1].shape[0]
        wave_sizes.add(n)
        if phase['sample'] != 1 or sched.bands[-1]['band'] != 0:
            return None
        band_calls.append(n)
        if len(band_calls) <= 3:
            return ('primary', 'shadow', 'bounce-1')[len(band_calls) - 1]
        return 'tail-1' if n == levels[0][2] else None

    sample_ms, sample_rays, per_sample = [], [], []
    kernels.reset_counts()
    with ScheduleTap() as sched, \
            Recorder(dispatch_mod, 'traverse_merged', pick=pick_wave) as trav, \
            Recorder(guiding_mod, 'segment_sum_pairs',
                     pick=lambda a, k: 0) as scat:
        for i in range(1 + CONVERGE_SAMPLES):
            phase['sample'] = i
            rays0 = int(pt.rays_traced)
            before = dict(kernels.LAUNCHES)
            first_band = len(sched.bands)
            ms, _ = cuda_ms(lambda: pt.render(cam, should_clear=(i == 0)))
            rays = int(pt.rays_traced) - rays0
            per_sample.append({k: kernels.LAUNCHES[k] - before[k]
                               for k in kernels.NAMES})
            bands = sched.bands[first_band:]
            rounds = {s: [b['rounds'].get(s, 0) for b in bands]
                      for s, _, _ in levels}
            log(f'sample {i} ({"clear" if i == 0 else "converge"}): '
                f'{ms:.1f} ms, {rays} rays, {rays / ms / 1e3:.2f} Mrays/s, '
                f'launches {per_sample[-1]}; tail rounds per band '
                + ', '.join(f'level@{s}: {r}' for s, r in rounds.items()))
            if i:
                sample_ms.append(ms)
                sample_rays.append(rays)
                if len(bands) != pt.bands or any(sum(r) < 1
                                                 for r in rounds.values()):
                    failures.append(f'sibenik converge sample {i} did not '
                                    f'take both tail levels: {rounds}')
        blur_ms, img = cuda_ms(lambda: pt.image(blur=True))
    torch.cuda.synchronize()
    sib_launches = dict(kernels.LAUNCHES)
    plain_on_cuda = dict(kernels.PLAIN_ON_CUDA)
    log(f'launches on the sibenik path: {sib_launches}; plain versions on '
        f'CUDA: {plain_on_cuda}; traverse wave widths {sorted(wave_sizes)}')
    energy, has_nan, has_neg = pt.energy()
    mrays = sum(sample_rays) / sum(sample_ms) / 1e3
    log(f'sibenik converge, {pt.bands} bands: {CONVERGE_SAMPLES} samples, '
        f'{sum(sample_ms) / len(sample_ms):.1f} ms/sample, {mrays:.2f} Mrays/s '
        f'on {card}; image(blur=True) {blur_ms:.2f} ms; energy={energy:.4f} '
        f'nan={has_nan} neg={has_neg}')
    if not (energy > 0 and energy == energy and energy != float('inf')):
        failures.append(f'sibenik energy {energy}')
    if has_nan or has_neg:
        failures.append(f'sibenik nan={has_nan} neg={has_neg}')
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        failures.append('blurred image is not finite [1080, 1920, 3]')
    for _, _, lanes in levels:
        if lanes not in wave_sizes:
            failures.append(f'traverse never ran on a {lanes}-lane tail wave')
    for name in SIBENIK_KERNELS:
        if sib_launches[name] <= 0:
            failures.append(f'{name}: no launch on the sibenik path')
    if sib_launches['traverse_packet']:
        failures.append('traverse_packet launched on the v2 sibenik path')
    if any(plain_on_cuda.values()):
        failures.append(f'plain versions ran on CUDA: {plain_on_cuda}')
    for name in SIBENIK_KERNELS:
        launches[name] = sib_launches[name]

    results = {}

    # ---- kernel vs plain: both traversals on the captured waves ----
    acc = {k: dict(ms=0.0, plain_ms=0.0, err=0.0, bytes=0.0, ops=0.0)
           for k in ('traverse', 'traverse_packet')}
    tables = tp1.PacketTables(pt.dyn.packet_inner, pt.dyn.packet_leaf,
                              pt.dyn.depth)

    def wave_line(name, wave, n_live, stats, ms, pms, n_bytes, n_ops, floor):
        b = bound(n_bytes, n_ops)[0]
        visits = stats['inner'] + stats['leaf']
        return (f'{name} {wave}: {stats["inner"]} inner + {stats["leaf"]} leaf '
                f'visits, {visits / max(n_live, 1):.2f} per live ray | kernel '
                f'{ms:.4f} ms, with no ray live {floor:.4f} ms, plain '
                f'{pms:.1f} ms, bound {b:.4f} ms, share of bound '
                f'{b / ms:.3f}')

    for wave in ('primary', 'shadow', 'bounce-1', 'tail-1'):
        if wave not in trav.saved:
            failures.append(f'traverse: no {wave} wave captured')
            continue
        (table, ro, rd, t0, live, stop), kw = trav.saved[wave]
        want_uv = kw.get('want_uv', False)
        any_hit = bool(stop.all())
        n_live = int(live.sum())
        dead = torch.zeros_like(live)
        ms, (t, gid, found, u, v) = cuda_ms(
            lambda: tp2.traverse_merged(table, ro, rd, t0, live, stop, want_uv),
            reps=10, warmup=1, preroll=True)
        floor, _ = cuda_ms(
            lambda: tp2.traverse_merged(table, ro, rd, t0, dead, stop, want_uv),
            reps=10, warmup=1, preroll=True)
        st2 = {}
        pms, (pt_, pgid, pfound, pu, pv) = cuda_ms(
            lambda: tp2.traverse_merged_ref(table, ro, rd, t0, live, stop,
                                            want_uv, stats=st2))
        same_found = bool(torch.equal(found, pfound))
        t_bits = int((t.view(torch.int32) != pt_.view(torch.int32)).sum())
        gid_diff = int((gid != pgid).sum())
        hits = int(found.sum())
        err = float((t - pt_)[found].abs().max()) if bool(found.any()) else 0.0
        uv_err = (float(torch.maximum((u - pu).abs(),
                                      (v - pv).abs())[found].max())
                  if want_uv and bool(found.any()) else 0.0)
        n_bytes, n_ops = traversal_work(ro.shape[0], 9 + (8 if want_uv else 0),
                                        st2)
        log(f'traverse {wave}: {ro.shape[0]} rays, {n_live} live, {hits} hits')
        log('  ' + wave_line('traverse', wave, n_live, st2, ms, pms, n_bytes,
                             n_ops, floor))
        log(f'  found equal={same_found}, t bit mismatches={t_bits}, gid '
            f'mismatches={gid_diff}, max|dt|={err}, max|duv|={uv_err}')
        if not same_found or t_bits:
            failures.append(f'traverse {wave}: kernel disagrees with plain')
        if gid_diff:
            failures.append(f'traverse {wave}: {gid_diff} gid mismatches')
        if uv_err > 1e-6:
            failures.append(f'traverse {wave}: uv differ by {uv_err}')
        a = acc['traverse']
        a['ms'] += ms
        a['plain_ms'] += pms
        a['err'] = max(a['err'], err)
        a['bytes'] += n_bytes
        a['ops'] += n_ops

        # v1 on the same wave (the dispatch walks any-hit waves cheap)
        ms1, (t1, gid1, found1) = cuda_ms(
            lambda: tp1.traverse_split(tables, ro, rd, t0, live, stop, any_hit),
            reps=10, warmup=1, preroll=True)
        floor1, _ = cuda_ms(
            lambda: tp1.traverse_split(tables, ro, rd, t0, dead, stop, any_hit),
            reps=10, warmup=1, preroll=True)
        st1 = {}
        pms1, (pt1, pgid1, pfound1) = cuda_ms(
            lambda: tp1.traverse_packet_ref(tables, ro, rd, t0, live, stop,
                                            any_hit, stats=st1))
        same_found1 = bool(torch.equal(found1, pfound1))
        t_bits1 = int((t1.view(torch.int32) != pt1.view(torch.int32)).sum())
        gid_diff1 = int((gid1 != pgid1).sum())
        err1 = float((t1 - pt1)[found1].abs().max()) if bool(found1.any()) else 0.0
        # against v2: found equal; closest t equal except where two triangles
        # tie to within rounding at an edge and the visit order picks the
        # other one (then the ids differ too)
        v2_found = bool(torch.equal(found1, found))
        t_off = found1 & (t1.view(torch.int32) != t.view(torch.int32))
        n_t_off = int(t_off.sum())
        tie_only = bool((gid1 != gid)[t_off].all()) if n_t_off else True
        rel_off = (float(((t1 - t).abs() / t.abs().clamp_min(1e-30))[t_off].max())
                   if n_t_off else 0.0)
        n_bytes1, n_ops1 = traversal_work(ro.shape[0], 9, st1)
        log('  ' + wave_line('traverse_packet', wave, n_live, st1, ms1, pms1,
                             n_bytes1, n_ops1, floor1))
        log(f'  vs plain: found equal={same_found1}, t bit mismatches='
            f'{t_bits1}, gid mismatches={gid_diff1} | vs v2: found equal='
            f'{v2_found}, t differs on {n_t_off} rays (all ties={tie_only}, '
            f'max rel {rel_off:.2e})')
        if not same_found1 or t_bits1:
            failures.append(f'traverse_packet {wave}: kernel disagrees with plain')
        if gid_diff1:
            failures.append(f'traverse_packet {wave}: {gid_diff1} gid mismatches')
        if not v2_found:
            failures.append(f'traverse_packet {wave}: found differs from v2')
        if not any_hit and (not tie_only or n_t_off > 0.001 * hits
                            or rel_off > 1e-5):
            failures.append(f'traverse_packet {wave}: t differs from v2 on '
                            f'{n_t_off} rays')
        a = acc['traverse_packet']
        a['ms'] += ms1
        a['plain_ms'] += pms1
        a['err'] = max(a['err'], err1)
        a['bytes'] += n_bytes1
        a['ops'] += n_ops1
    for name, a in acc.items():
        results[name] = dict(max_abs_err=a['err'], ms=a['ms'],
                             plain_ms=a['plain_ms'], library_ms=None)
        results[name]['bound_ms'], results[name]['bound_by'] = bound(
            a['bytes'], a['ops'])

    # ---- kernel vs plain: guiding scatter on the first converge sample ----
    (e, w, seg, n_bins), _ = scat.saved[0]
    ms, (ke, kw_) = cuda_ms(lambda: gs_mod.segment_sum_pairs(e, w, seg, n_bins),
                            reps=5, warmup=1, preroll=True)
    pms, (pe, pw) = cuda_ms(lambda: gs_mod.segment_sum_pairs_ref(e, w, seg, n_bins),
                            reps=5, warmup=1, preroll=True)
    # the library yardstick: one index_add_ of the (e, w) pairs
    idx = seg.to(torch.int64)
    pairs = torch.stack([e, w], dim=1)
    lib_out = torch.zeros((n_bins + 1, 2), dtype=torch.float32, device='cuda')
    lms, _ = cuda_ms(lambda: lib_out.index_add_(0, idx, pairs), reps=5,
                     warmup=1, preroll=True)
    err = float(torch.maximum((ke - pe).abs().max(), (kw_ - pw).abs().max()))
    ok = (torch.allclose(ke, pe, rtol=1e-5, atol=1e-5)
          and torch.allclose(kw_, pw, rtol=1e-5, atol=1e-5))
    kept = int((seg < n_bins).sum())
    b = bound(4 * e.shape[0] + 8 * kept + 8 * n_bins, 2 * kept)
    log(f'guiding_scatter: {e.shape[0]} updates ({kept} kept) into {n_bins} '
        f'bins | kernel {ms:.3f} ms, plain {pms:.3f} ms, index_add_ {lms:.3f} '
        f'ms, bound {b[0]:.4f} ms ({b[1]}) | max|d|={err}, within rtol 1e-5: '
        f'{ok}')
    if not ok:
        failures.append('guiding_scatter: kernel disagrees with plain')
    results['guiding_scatter'] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                      bound_ms=b[0], bound_by=b[1],
                                      library_ms=lms)

    # ---- kernel vs plain: blur on the final accumulators ----
    n = float(pt.sample_idx)
    lum_px, alb_px = pt.accumulators_pixel_order()
    ms, kout = cuda_ms(lambda: blur_mod.blur_luminance(lum_px, alb_px, n, WIDTH,
                                                       HEIGHT),
                       reps=5, warmup=1, preroll=True)
    pms, pout = cuda_ms(lambda: blur_mod.blur_luminance_ref(lum_px, alb_px, n,
                                                            WIDTH, HEIGHT),
                        reps=5, warmup=1, preroll=True)
    err = float((kout - pout).abs().max())
    # bit for bit: the kernel sums the taps in the plain version's order
    ok = bool(torch.isfinite(kout).all()) and torch.equal(
        kout.view(torch.int32), pout.view(torch.int32))
    # accumulators (2 x f32x4) read once, the f32x3 image written once; per
    # pixel 7 horizontal taps x 3 channels x 5 ops and 8 vertical x 3 x 2,
    # plus the weight sums and 6 divides
    px = WIDTH * HEIGHT
    b = bound(px * (32 + 12), px * (7 * 3 * 5 + 8 * 3 * 2 + 15 + 6))
    log(f'blur: {WIDTH}x{HEIGHT}, n={n} | kernel {ms:.3f} ms, plain {pms:.3f} '
        f'ms, bound {b[0]:.4f} ms ({b[1]}) | max|d|={err}, bit-equal: {ok}')
    if not ok:
        failures.append('blur: kernel disagrees with plain')
    results['blur'] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0],
                           bound_by=b[1], library_ms=None)
    del lum_px, alb_px, trav, scat

    # ---- the same converge path with the frame as one band ----
    lane_cap = Pathtracer.MAX_LANES_PER_DISPATCH
    one_ms, one_rays, wave_sizes1 = [], [], set()
    with patched(Pathtracer, 'MAX_LANES_PER_DISPATCH', WIDTH * HEIGHT), \
            ScheduleTap() as sched1, \
            Recorder(dispatch_mod, 'traverse_merged',
                     pick=lambda a, k: wave_sizes1.add(a[1].shape[0])):
        pt._set_bands(band_geometry(WIDTH, HEIGHT, 1,
                                    Pathtracer.MAX_LANES_PER_DISPATCH)[0])
        levels1 = ptm.tail_levels(WIDTH * pt.band_h, MAX_RAY_DEPTH)
        pt.render(cam, should_clear=True)
        for _ in range(2):
            rays0 = int(pt.rays_traced)
            ms, _ = cuda_ms(lambda: pt.render(cam))
            one_ms.append(ms)
            one_rays.append(int(pt.rays_traced) - rays0)
    one_rounds = {s: sched1.rounds(s) for s, _, _ in levels1}
    log(f'sibenik converge, {pt.bands} band of {pt.band_h} rows (lane cap '
        f'raised from {lane_cap} to {WIDTH * HEIGHT}): tail levels {levels1}, '
        f'rounds over 2 samples {one_rounds}, traverse wave widths '
        f'{sorted(wave_sizes1)}; 2 samples {one_ms[0]:.1f} / {one_ms[1]:.1f} '
        f'ms, {sum(one_ms) / 2:.1f} ms/sample, '
        f'{sum(one_rays) / sum(one_ms) / 1e3:.2f} Mrays/s on {card} (default '
        f'{pt_bands} bands: {sum(sample_ms) / len(sample_ms):.1f} ms/sample, '
        f'{mrays:.2f} Mrays/s)')
    if any(r < 1 for r in one_rounds.values()):
        failures.append(f'one band: a tail level never ran {one_rounds}')
    del pt, scene
    torch.cuda.empty_cache()

    # ---- path 2: the CLI on the animated outside scene (v1, then v2) ----
    with tempfile.TemporaryDirectory() as tmp:
        renders = {}
        for v1 in (True, False):
            tag = 'v1' if v1 else 'v2'
            args = OUTSIDE_ARGS + ['--out', os.path.join(tmp, f'{tag}.png'),
                                   '--state', os.path.join(tmp, f'{tag}.txt')]
            kernels.reset_counts()
            t = time.perf_counter()
            with ScheduleTap() as sched_o:
                rc, err_text, app, out_scene = run_cli(cli_main, args, v1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = dict(kernels.LAUNCHES)
            plain = dict(kernels.PLAIN_ON_CUDA)
            m = re.search(r'^energy (\S+) nan=(\w+) neg=(\w+)$', err_text, re.M)
            log(f'outside {tag}: rc={rc}, {wall:.2f} s wall, {app.sample_idx} '
                f'samples, refits {out_scene.refits}; launches {got}; plain '
                f'versions on CUDA: {plain}; {app.bands} bands of '
                f'{app.band_h} rows, level-1 tail rounds per band call '
                f'{[b["rounds"].get(ptm.TAIL_START, 0) for b in sched_o.bands]}'
                f' ({sched_o.rounds(ptm.TAIL_START)} in all)')
            if rc != 0 or m is None:
                failures.append(f'outside {tag}: CLI failed (rc={rc})')
                continue
            energy = float(m.group(1))
            if not (0 < energy < float('inf')) or m.group(2) != 'False' \
                    or m.group(3) != 'False':
                failures.append(f'outside {tag}: energy {m.group(0)}')
            if os.path.getsize(os.path.join(tmp, f'{tag}.png')) == 0:
                failures.append(f'outside {tag}: empty PNG')
            if out_scene._refit_templates is None or out_scene.refits < 1:
                failures.append(f'outside {tag}: the refit path was not taken')
            if any(plain.values()):
                failures.append(f'outside {tag}: plain versions on CUDA {plain}')
            if v1:
                for name in OUTSIDE_KERNELS:
                    if got[name] <= 0:
                        failures.append(f'{name}: no launch on the outside path')
                if got['traverse']:
                    failures.append('traverse launched with PACKET_V1 on')
                launches['traverse_packet'] = got['traverse_packet']
                log(f'outside v1 per frame: launches {got} over '
                    f'{app.sample_idx} samples in one clearing frame')
                # refit on the card against a forced full rebuild
                refit = out_scene.dynamic_arrays('cuda')
                out_scene._refit_templates = None
                out_scene._dyn_cache = None
                full = out_scene.dynamic_arrays('cuda')
                worst = 0.0
                for f in ('packet_inner', 'packet_leaf', 'packet_merged'):
                    a, b_ = getattr(refit, f), getattr(full, f)
                    nan_ok = a.shape == b_.shape and bool(
                        torch.equal(torch.isnan(a), torch.isnan(b_)))
                    d = float((a - b_)[~torch.isnan(a)].abs().max()) if nan_ok \
                        else float('inf')
                    worst = max(worst, d)
                    if not nan_ok or d > 2e-4:
                        failures.append(f'refit {f}: max|d|={d}, NaN slots '
                                        f'equal={nan_ok}')

                def canon(dy):
                    key = dy.tri_inst.long() * (1 << 31) + dy.tri_gid.long()
                    return dy.world_tris[torch.argsort(key)]
                d = float((canon(refit) - canon(full)).abs().max())
                worst = max(worst, d)
                if d > 2e-4:
                    failures.append(f'refit world_tris: max|d|={d}')
                log(f'refit on the card vs full rebuild: max|d|={worst} '
                    f'(atol 2e-4, NaN slots equal)')
            renders[tag] = app.accumulators_pixel_order()[0].clone()
            del app, out_scene
        if len(renders) == 2:
            close = torch.isclose(renders['v1'][:, :3], renders['v2'][:, :3],
                                  rtol=1e-3, atol=1e-5).all(dim=1)
            share = float(close.float().mean())
            log(f'outside v1 vs v2 (refit-derived merged table): {share:.6f} of '
                f'pixels agree within rtol 1e-3')
            if share < 0.995:
                failures.append(f'outside: only {share:.6f} of pixels agree '
                                f'between v1 and v2')

    # ---- end to end on a small input: the room on the card vs the CPU,
    # below the tail gate and in the full-size schedule at a small size ----
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    'tests'))
    from _torch_room import build_room, CAMERA
    from cuda_pathtracer_tpu_torch.scene import scene as scene_mod

    def room(device, w, h, frames):
        small = Pathtracer(build_room(scene_mod, builder.add_cube), w, h,
                           device=device)
        c = Camera.create(**CAMERA, device=device)
        ridx = []
        for clear in frames:
            small.render(c, should_clear=clear)
            ridx.append(small.rand_idx)
        return small.accumulators_pixel_order()[0].cpu(), ridx, small.bands

    def agree(a, b):
        return torch.isclose(a[:, :3], b[:, :3], rtol=1e-3,
                             atol=1e-5).all(dim=1).float().mean().item()

    (lc, _, _), (lh, _, _) = (room(d, 64, 48, (True, False, False, False))
                              for d in ('cuda', 'cpu'))
    close = agree(lc, lh)
    log(f'room 64x48, clear + 3 converge samples: {close:.4f} of pixels agree '
        f'between the CUDA path and the CPU path')
    if close < 0.99:
        failures.append(f'room render: only {close:.4f} of pixels agree')
    for spp in (1, 2):
        # spp 2 batches two sample-major lane blocks per dispatch: per-lane
        # rand_idx windows, one guiding scatter over offset segment ids and
        # the EMA once per sample
        runs = {}
        with patched(ptm, 'TAIL_MIN_LANES', 2048), \
                patched(Pathtracer, 'MAX_LANES_PER_DISPATCH', 2048), \
                patched(Pathtracer, 'SPP_PER_DISPATCH', spp):
            for d in ('cuda', 'cpu'):
                with ScheduleTap() as sched_r:
                    runs[d] = room(d, 64, 64, (True, False, False))
                runs[d] += (sched_r.rounds(ptm.TAIL_START),
                            sched_r.rounds(ptm.TAIL2_START),
                            max(b['rounds'].get(ptm.TAIL_START, 0)
                                for b in sched_r.bands))
        close = agree(runs['cuda'][0], runs['cpu'][0])
        log(f'room 64x64 at spp {spp} in {runs["cuda"][2]} bands of 2048 '
            f'lanes, tail gate 2048, clear + 2 converge dispatches: rand_idx '
            f'per frame {runs["cuda"][1]} (card) vs {runs["cpu"][1]} (CPU), '
            f'tail rounds (level 1, level 2) {runs["cuda"][3:5]} vs '
            f'{runs["cpu"][3:5]}; {close:.4f} of pixels agree')
        if runs['cuda'][1] != runs['cpu'][1] or close < 0.99 \
                or runs['cuda'][5] <= 1:
            failures.append(f'tail room at spp {spp}: the card and the CPU '
                            f'disagree, or level 1 took one round per band')

    run_probes(launches, results, failures)

    loaded = sorted(m for m in sys.modules
                    if (m in ('jax', 'cuda_pathtracer_tpu')
                        or m.startswith(('jax.', 'cuda_pathtracer_tpu.')))
                    and sys.modules[m] is not None)
    if loaded:
        failures.append(f'modules of JAX or the JAX package were imported: '
                        f'{loaded}')
    if failures:
        for f in failures:
            print('FAIL: ' + f, file=sys.stderr)
        return 1

    print(json.dumps({'kernels': [
        {'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
         'launches': launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
