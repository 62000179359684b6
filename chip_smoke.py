"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards 4     # only --shard across 4 cards

Builds the fourteen hand-written CUDA kernels from ``cuda_pathtracer_tpu_torch/
csrc`` and drives the port's render paths once at full size (phases 1-3
and 5-7), then the eight probe kernels' sweeps (phase 4, run last):

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

3. the rest of the CLI: (a) the Whitted raytracer at 1920x1080: sibenik on
   v2, a clearing frame (depth 2) and a converged one (depth 7); ``python -m
   cuda_pathtracer_tpu_torch --scene outside --mode ray --width 1920
   --height 1080 --time 5`` in this process with ``PACKET_V1`` on and then
   off (one depth-2 frame after the refit), then one depth-7 frame on each
   route; per frame the device ms (CUDA events) and host wall, lanes,
   active lanes and lanes the cap dropped per level, the traversal launches
   and their device ms (profiler), rays traced and Mrays/s; on each of the
   three depth-7 frames the level-0 closest-hit and shadow waves (2,073,600
   lanes) are recorded and traced again on the kernels and on the plain
   prepass and walk (every field of the hit bit-identical, ``hold_level0``;
   the prepass kernel alone against the plain prepass, timed with its
   bound by bytes, ``hold_prepass``), and every level
   of each is shaded again by the two ``whitted_shade`` kernels and by the
   plain route on the same rays and hits, each lane its own pixel: shadow
   rays, contributions, children and shadow-ray counts bit-equal, each
   kernel timed with its bound by bytes (``hold_shading``); v1 and v2 must
   agree on 99.5% of the pixels, and so must a 64x48 depth-7 outside frame
   on the card and on the CPU. (b) ``--serve <a free port> --frames 30`` on
   outside at 640x480, in path mode and in ray mode, while a thread sends
   the key ``w`` and fetches ``/frame.png`` until one frame has come (its
   IHDR must say 640x480, the saved eye must have moved, the fps EMA lines
   must be printed); frames/s is counted over the frames after that thread
   stopped. (c) checkpoint and resume of outside at 1920x1080
   (``run_checkpoint``).
4. the ``tools`` probes (``cuda_pathtracer_tpu_torch/tools/``), the Hopper
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
5. the other scenes (``run_scenes``, before the probes), at 1920x1080, each
   run with its launch counts set to 0 just before it and read just after:
   (a) ``minecraft`` (the voxel world, 70,328 triangles) with the JAX golden
   ``minecraft_guided`` camera and guiding on: a clear frame, 4 converge
   samples and the blurred display; ``traverse``, ``guiding_scatter`` and
   ``blur`` must launch. (b) ``2mtris`` (the procedural statue, 2,000,772
   triangles, its merged table past the L2): the host build by part (mesh,
   BVH with the native builder's route and flags, wide collapse and tables,
   upload), a clear frame and 2 converge samples on v2, one profiled sample
   (Mrays/s over busy time), then one depth-7 Whitted frame whose level-0
   closest-hit and shadow waves are held to the plain walks on v2 and on
   v1 (``hold_level0``). On both scenes the first band's primary, shadow
   and bounce-1 waves of the first converge sample are held to the plain
   walk (found, t and gid bit-identical) and printed with their visits per
   live ray and ns per visit beside sibenik's same waves. (c) a ``.chai``
   script (a user function, a loop, a diffuse and an emissive material, a
   plane, a missing model) through ``python -m cuda_pathtracer_tpu_torch
   --scene s.chai --width 1920 --height 1080 --spp 2 --blur``, in this
   process; its image must equal bit for bit the same scene built through
   the Scene API and rendered by the same steps.

6. ``--shard`` and JPEG (``run_shard``, after phase 5): (a) a world of one
   rank on NCCL in this process: sibenik at 1920x1080 in the default
   geometry (5 bands of 216 rows), a clear frame and 2 converge samples,
   held bit for bit to the single engine after every frame (``lum``,
   ``alb``, the radiance cache and total, ``rand_idx``, ``sample_idx``);
   (b) two ranks that share the card, on gloo, as spawned processes
   (``shard_rank``): 6 bands of 180 rows, tile order off, held to the single
   engine forced to the same bands: ``lum`` bit-equal after the clear frame
   and the first converge sample, ``rand_idx`` equal, the radiance cache
   within rtol 1e-4 / atol 1e-5, after the second sample the weight channel
   equal and the mean within 2%; ``traverse`` and ``guiding_scatter`` must
   launch on every rank, ``blur`` on rank 0's image, no plain version on
   CUDA; the ms per converge sample at one rank and at two ranks (host
   wall, CUDA events, profiler busy time); (c) ``python -m
   cuda_pathtracer_tpu_torch --shard --scene outside --width 1920 --height
   1080 --time 5 --spp 4 --blur`` as a subprocess (one card: a world of
   one), its PNG equal to the same command's without ``--shard``; (d) the
   JPEG fixtures of ``tests/data/jpeg`` decoded to the digests of PIL's
   decodes in ``digests.json``, then ``outside`` at 1920x1080 with a
   fixture as ``skydome.jpg``: its ``sky_img`` equals the decode and its
   image differs from the grey-sky render.
7. images (``run_images``, after phase 6): (a) every fixture of
   ``tests/data/images`` (PNG, TGA, BMP, GIF, PNM, PSD) decoded to the
   digests of PIL's decodes (mode, shape, SHA-256); (b) a 4096x2048 RGB PNG
   sky whose rows cycle through the five filter types, the same sky Adam7-
   interlaced, a 2048x2048 RLE RGBA TGA and a 2048x2048 8-bit palette BMP,
   encoded from seeded arrays by ``tests/_torch_images.py`` and decoded on
   the host equal to them, each with its decode seconds beside the card's
   name and power limit; (c) ``outside`` at 1920x1080 with the PNG as its
   sky (a clear frame, 2 samples, the blurred image): ``sky_img`` equals
   the decode, energy finite and unlike the grey sky's; the quad room of
   ``tests/test_torch_images.py`` at 1920x1080 with the TGA as ``map_Kd``
   and the BMP as ``norm``: texels equal the decodes, energy finite and
   > 0; each render with its launch counts set to 0 just before it,
   ``traverse`` and ``blur`` required; (d) a palette PNG sky loads and a
   truncated one raises OSError instead of leaving the grey sky; (e)
   (``run_refused_images``) the files the port once refused, encoded from
   seeded arrays: a 4096x2048 progressive arithmetic-coded JPEG of a
   smooth sky, a 1024x512 CMYK JPEG and a 4096x2048 PackBits RGB PSD, each
   decoded on the host (the PSD to its array; each JPEG to a second
   coder's decode of the same coefficients) with its seconds beside the
   card, then ``outside`` at 1920x1080 with the arithmetic file as
   ``skydome.jpg`` as in (c).

``--cards N`` runs only ``--shard`` across N cards of one host, one rank per
card on NCCL (``run_cards``): N spawned ranks held to the single engine at
their geometry as in 6b, then the CLI's ``--shard`` with the ranks it starts
itself and with N ranks in torchrun's environment that each see one card.

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
import socket
import struct
import sys
import tempfile
import threading
import time
import urllib.request

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
    'whitted_shade': ('cuda_pathtracer_tpu_torch/csrc/whitted_shade.cu',
                      'none (models/raytracer.py::_shade_level)'),
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
    'prepass': ('cuda_pathtracer_tpu_torch/csrc/traverse.cu (prepass_kernel)',
                'none (ops/traverse.py::_primitives_prepass)'),
}
# the kernels each path must launch
SIBENIK_KERNELS = ('traverse', 'guiding_scatter', 'blur')
OUTSIDE_KERNELS = ('traverse_packet', 'blur')
WIDTH, HEIGHT = 1920, 1080
CONVERGE_SAMPLES = 4
OUTSIDE_ARGS = ['--scene', 'outside', '--width', str(WIDTH), '--height',
                str(HEIGHT), '--time', '5', '--spp', '4', '--blur',
                '--device', 'cuda']

# the real-time loop at the reference's own size (BASELINE.md:10), and the
# camera the CLI tests use on outside (eye, view, d, focal length, aperture)
LOOP_WIDTH, LOOP_HEIGHT, LOOP_FRAMES = 640, 480, 30
OUTSIDE_STATE = '0|4|-17\n0|-0.2|1\n1.5\n12\n0.02\n'
OUTSIDE_EYE = [0.0, 4.0, -17.0]
SIBENIK_CAMERA = ([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0)
# minecraft: the JAX golden minecraft_guided's camera
# (tests/test_goldens_configs.py); 2mtris: 5 units in front of the statue
# (12 tall, radius 2.1), which then covers about half of the frame
MINECRAFT_CAMERA = ([0.0, 6.0, -14.0], [0.0, -0.15, 1.0], 1.5, 10.0, 0.0)
STATUE_CAMERA = ([0.0, 6.0, -5.0], [0.0, 0.0, 1.0], 1.5, 5.0, 0.0)

# FP32 operations per visit, as the kernels do them: an inner visit slab-tests
# 16 slots (6 mul, 6 sub, 6 min/max, 4 for the tmin/tmax reductions, 1 max,
# 2 compares); a leaf visit runs Moller-Trumbore on 12 triangles (56 each:
# the cross, dot, reciprocal, u/v/t products and the 8 acceptance tests)
SLAB_OPS = 16 * 25
LEAF_OPS = 12 * 56
# bytes a lane the Whitted shading must move through HBM
# (csrc/whitted_shade.cu): each launch reads the ray and its closest hit
# (37); shade_pre writes a shadow ray a light (29); shade_post reads the
# weight and pixel (20) and a shadow hit a light (1), reads and writes the
# frame's pixel (24) and writes the two children (90). The gathers of
# triangle, instance and material rows are left out: sibenik's four
# triangle arrays are 3.95 MB, served from the 50 MB L2 (with 24 bytes a
# lane counted for them, sibenik's level-0 shade_pre ran above the memory
# rate).
SHADE_PRE_BYTES, SHADE_PRE_LIGHT_BYTES = 37, 29
SHADE_POST_BYTES, SHADE_POST_LIGHT_BYTES = 37 + 20 + 24 + 90, 1
# bytes a ray the sphere/plane prepass (csrc/traverse.cu's prepass_kernel)
# must move through HBM: it reads the ray (24) and, where given, t_max (4),
# active and stop_on_hit (1 each), and writes t, prim_type, prim_id (12),
# found, live and stop (3). The spheres and planes, a few hundred bytes,
# are left out: L2 serves them.
PREPASS_RAY_BYTES, PREPASS_OUT_BYTES = 24, 15


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


def wave_line(name, wave, n_live, stats, ms, pms, n_bytes, n_ops, floor):
    b = bound(n_bytes, n_ops)[0]
    visits = stats['inner'] + stats['leaf']
    return (f'{name} {wave}: {stats["inner"]} inner + {stats["leaf"]} leaf '
            f'visits, {visits / max(n_live, 1):.2f} per live ray | kernel '
            f'{ms:.4f} ms, with no ray live {floor:.4f} ms, plain '
            f'{pms:.1f} ms, bound {b:.4f} ms, share of bound '
            f'{b / ms:.3f}')


def hold_merged(label: str, wave: str, saved, failures: list) -> dict:
    """The v2 kernel on one recorded ``traverse_merged`` call against its
    plain walk on the card: found, t and gid bit-identical, u and v within
    1e-6. The kernel is timed over 10 runs, and so is the same launch with
    no ray live (the launch floor). Returns the wave's figures and the
    kernel's (t, gid, found)."""
    import torch
    from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as tp2
    (table, ro, rd, t0, live, stop), kw = saved
    want_uv = kw.get('want_uv', False)
    n_live = int(live.sum())
    dead = torch.zeros_like(live)
    ms, (t, gid, found, u, v) = cuda_ms(
        lambda: tp2.traverse_merged(table, ro, rd, t0, live, stop, want_uv),
        reps=10, warmup=1, preroll=True)
    floor, _ = cuda_ms(
        lambda: tp2.traverse_merged(table, ro, rd, t0, dead, stop, want_uv),
        reps=10, warmup=1, preroll=True)
    st = {}
    pms, (pt_, pgid, pfound, pu, pv) = cuda_ms(
        lambda: tp2.traverse_merged_ref(table, ro, rd, t0, live, stop,
                                        want_uv, stats=st))
    same_found = bool(torch.equal(found, pfound))
    t_bits = int((t.view(torch.int32) != pt_.view(torch.int32)).sum())
    gid_diff = int((gid != pgid).sum())
    hits = int(found.sum())
    err = float((t - pt_)[found].abs().max()) if bool(found.any()) else 0.0
    uv_err = (float(torch.maximum((u - pu).abs(),
                                  (v - pv).abs())[found].max())
              if want_uv and bool(found.any()) else 0.0)
    n_bytes, n_ops = traversal_work(ro.shape[0], 9 + (8 if want_uv else 0),
                                    st)
    log(f'{label} {wave}: {ro.shape[0]} rays, {n_live} live, {hits} hits')
    log('  ' + wave_line(label, wave, n_live, st, ms, pms, n_bytes, n_ops,
                         floor))
    log(f'  found equal={same_found}, t bit mismatches={t_bits}, gid '
        f'mismatches={gid_diff}, max|dt|={err}, max|duv|={uv_err}')
    if not same_found or t_bits:
        failures.append(f'{label} {wave}: kernel disagrees with plain')
    if gid_diff:
        failures.append(f'{label} {wave}: {gid_diff} gid mismatches')
    if uv_err > 1e-6:
        failures.append(f'{label} {wave}: uv differ by {uv_err}')
    visits = st['inner'] + st['leaf']
    return dict(ms=ms, floor=floor, plain_ms=pms, err=err, bytes=n_bytes,
                ops=n_ops, rays=ro.shape[0], n_live=n_live, hits=hits,
                visits=visits, share=bound(n_bytes, n_ops)[0] / ms,
                out=(t, gid, found))


def converge(pt, cam, samples: int, label: str, kernels_on: tuple,
             failures: list) -> dict:
    """A clear frame and ``samples`` converge samples of ``pt`` in the
    engine's default schedule, then the blurred display image, with the
    launch counts set to 0 just before and read just after: every kernel of
    ``kernels_on`` must have launched, and no plain version may have run on
    the card. Records the first band's primary, shadow and bounce-1 waves of
    the first converge sample. Checks the energy (finite, > 0, no NaN or
    negative value) and the image. Returns the recorded waves, the launches,
    the energy and the ms and rays of each converge sample."""
    import torch
    from cuda_pathtracer_tpu_torch.ops import dispatch as dispatch_mod
    from cuda_pathtracer_tpu_torch.ops import kernels
    from cuda_pathtracer_tpu_torch.utils.frame_profile import ScheduleTap
    phase = {'sample': None}
    calls = []

    def pick(args, kw):
        if phase['sample'] != 1 or sched.bands[-1]['band'] != 0:
            return None
        calls.append(args[1].shape[0])
        return ('primary', 'shadow', 'bounce-1')[len(calls) - 1] \
            if len(calls) <= 3 else None

    sample_ms, sample_rays = [], []
    kernels.reset_counts()
    with ScheduleTap() as sched, \
            Recorder(dispatch_mod, 'traverse_merged', pick=pick) as trav:
        for i in range(1 + samples):
            phase['sample'] = i
            rays0 = int(pt.rays_traced)
            ms, _ = cuda_ms(lambda: pt.render(cam, should_clear=(i == 0)))
            rays = int(pt.rays_traced) - rays0
            log(f'{label} sample {i} ({"clear" if i == 0 else "converge"}): '
                f'{ms:.1f} ms, {rays} rays, {rays / ms / 1e3:.2f} Mrays/s '
                f'over the span')
            if i:
                sample_ms.append(ms)
                sample_rays.append(rays)
        blur_ms, img = cuda_ms(lambda: pt.image(blur=True))
    torch.cuda.synchronize()
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    plain = {k: v for k, v in kernels.PLAIN_ON_CUDA.items() if v}
    energy, has_nan, has_neg = pt.energy()
    log(f'{label}: {pt.bands} bands of {pt.band_h} rows; launches {got}; '
        f'plain versions on CUDA {plain}; {samples} converge samples '
        f'{sum(sample_ms) / samples:.1f} ms/sample, '
        f'{sum(sample_rays) / sum(sample_ms) / 1e3:.2f} Mrays/s over the '
        f'span; image(blur=True) {blur_ms:.2f} ms; energy={energy:.4f} '
        f'nan={has_nan} neg={has_neg}')
    for name in kernels_on:
        if got.get(name, 0) <= 0:
            failures.append(f'{label}: {name} did not launch')
    if got.get('traverse_packet'):
        failures.append(f'{label}: traverse_packet launched on v2')
    if plain:
        failures.append(f'{label}: plain versions on CUDA {plain}')
    if not (0 < energy < float('inf')) or has_nan or has_neg:
        failures.append(f'{label}: energy {energy} nan={has_nan} '
                        f'neg={has_neg}')
    if tuple(img.shape) != (pt.height, pt.width, 3) or not bool(
            torch.isfinite(img).all()):
        failures.append(f'{label}: blurred image not finite '
                        f'[{pt.height}, {pt.width}, 3]')
    return dict(saved=trav.saved, launches=got, energy=energy,
                sample_ms=sample_ms, sample_rays=sample_rays)


def hold_converge_waves(label: str, run: dict, failures: list, beside=None):
    """``hold_merged`` on the primary, shadow and bounce-1 waves that
    ``converge`` recorded, with each wave's kernel time above its launch
    floor per visit of the plain walk, beside ``beside``'s same waves."""
    out = {}
    for wave in ('primary', 'shadow', 'bounce-1'):
        if wave not in run['saved']:
            failures.append(f'{label}: no {wave} wave recorded')
            continue
        h = out[wave] = hold_merged(label, wave, run['saved'][wave],
                                    failures)
        del h['out']
    for wave, h in out.items():
        line = (f'  {label} {wave}: {h["n_live"]} live of {h["rays"]}, '
                f'{h["visits"] / max(h["n_live"], 1):.2f} visits per live ray, '
                f'kernel {h["ms"]:.4f} ms (floor {h["floor"]:.4f}), '
                f'{ns_per_visit(h):.4f} ns above the floor per visit, '
                f'share of bound {h["share"]:.3f}')
        if beside and wave in beside:
            b = beside[wave]
            line += (f' | sibenik: {b["visits"] / max(b["n_live"], 1):.2f} '
                     f'visits per live ray, kernel {b["ms"]:.4f} ms, '
                     f'{ns_per_visit(b):.4f} ns per visit')
        log(line)
    return out


def ns_per_visit(h: dict) -> float:
    """Kernel time above the launch floor per visit of the plain walk, in
    ns (nan on a wave with no visit)."""
    return (h['ms'] - h['floor']) / h['visits'] * 1e6 if h['visits'] \
        else float('nan')


# the .chai script of phase 5c: a user function, a loop, a diffuse and an
# emissive material, a plane, and a model the asset path lacks (the
# cathedral stands in); chai_twin builds the same scene through the API
CHAI_SCRIPT = """
def pillar(model, x, z, h) {
    var p = GameObject(model)
    p.position = make_float3(x, h - 3.0, z)
    p.scale = make_float3(0.5, h, 0.5)
    p.rotation.y = x * 0.1
    return p
}
var stone = scene_add_material(DiffuseMaterial(make_float3(0.7, 0.6, 0.5)))
var lamp_m = DiffuseMaterial(make_float3(1.0))
lamp_m.emission = make_float3(8.0, 7.0, 6.0)
var lamp = scene_add_material(lamp_m)
var cube = scene_add_model("cube.obj", 1.0, make_float3(0, 0, 0),
                           make_float3(0, 0, 0), stone, false)
for (var i = 0; i < 4; ++i) {
    scene_add_object(pillar(cube, -4.5 + 3 * i, 2.0, 1.0 + 0.5 * i))
}
var lamp_cube = scene_add_model("cube.obj", 1.0, make_float3(0, 0, 0),
                                make_float3(0, 0, 0), lamp, false)
var light = GameObject(lamp_cube)
light.position = make_float3(0, 5, 0)
light.scale = make_float3(1.5, 0.2, 1.5)
scene_add_object(light)
scene_add_plane(Plane(make_float3(0, -1, 0), -3.0, stone))
var hall = scene_add_model("not_in_the_repo.obj", 1.0, make_float3(0, 0, 0),
                           make_float3(0, 0, 0), stone, false)
var h = GameObject(hall)
h.position.y = 12
scene_add_object(h)
"""
CHAI_STATE = '0|2|-9\n0|-0.1|1\n1.5\n9\n0.02\n'


def chai_twin(asset_dir: str):
    """CHAI_SCRIPT's scene, built through the Scene API."""
    from cuda_pathtracer_tpu_torch.scene import procedural
    from cuda_pathtracer_tpu_torch.scene.scene import (GameObject, Material,
                                                       Plane, Scene)
    scene = Scene(asset_dirs=[asset_dir])
    stone = scene.add_material(Material.DIFFUSE((0.7, 0.6, 0.5)))
    lamp_m = Material.DIFFUSE((1.0, 1.0, 1.0))
    lamp_m.emission = (8.0, 7.0, 6.0)
    lamp = scene.add_material(lamp_m)
    cube = scene.add_model('cube.obj', 1.0, (0, 0, 0), (0, 0, 0), stone)
    for i in range(4):
        x, h = -4.5 + 3 * i, 1.0 + 0.5 * i
        scene.add_object(GameObject(cube, position=[x, h - 3.0, 2.0],
                                    scale=[0.5, h, 0.5],
                                    rotation=[0.0, x * 0.1, 0.0]))
    lamp_cube = scene.add_model('cube.obj', 1.0, (0, 0, 0), (0, 0, 0), lamp)
    scene.add_object(GameObject(lamp_cube, position=[0, 5, 0],
                                scale=[1.5, 0.2, 1.5]))
    scene.add_plane(Plane((0.0, -1.0, 0.0), -3.0, stone))
    hall = procedural.add_cathedral(scene, stone)
    scene.add_object(GameObject(hall, position=[0, 12, 0]))
    scene.finalize()
    return scene


def run_scenes(cli_main, sib_waves: dict, tmp: str, failures: list) -> dict:
    """Phase 5: the scenes of slice 9 at 1920x1080. (a) minecraft converge
    with guiding on; (b) 2mtris, its build by part, converge on v2 and a
    depth-7 Whitted frame with its level-0 waves held on v2 and v1; (c) a
    ``.chai`` script through the CLI, held to its twin built in process.
    Returns {run: launches}."""
    import torch
    from cuda_pathtracer_tpu_torch.core.camera import Camera
    from cuda_pathtracer_tpu_torch.models import raytracer as rt_mod
    from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu_torch.ops import dispatch as dispatch_mod
    from cuda_pathtracer_tpu_torch.ops import kernels
    from cuda_pathtracer_tpu_torch.scene import builder
    from cuda_pathtracer_tpu_torch.scene import scene as scene_mod
    from cuda_pathtracer_tpu_torch.scene import state as state_mod
    from cuda_pathtracer_tpu_torch.utils import profiling
    counts = {}

    # (a) minecraft, the minecraft_guided camera, guiding on (the default)
    t = time.perf_counter()
    scene = builder.get_scene('minecraft')
    pt = Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    torch.cuda.synchronize()
    log(f'scene: minecraft {len(scene._tri_mat)} triangles, merged BVH '
        f'{pt.dyn.packet_merged.shape[0]} rows '
        f'({pt.dyn.packet_merged.nbytes / 1e6:.1f} MB), depth {pt.dyn.depth}; '
        f'host build + upload {time.perf_counter() - t:.2f} s')
    cam = Camera.create(*MINECRAFT_CAMERA, device='cuda')
    run = converge(pt, cam, CONVERGE_SAMPLES, 'minecraft', SIBENIK_KERNELS,
                   failures)
    counts['minecraft'] = run['launches']
    hold_converge_waves('traverse minecraft', run, failures, sib_waves)
    del pt, scene, run
    torch.cuda.empty_cache()

    # (b) 2mtris: the build by part
    spent = {}

    def timed(name, part):
        fn = getattr(scene_mod, name)

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            key = (stage['now'], part)
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
            return out
        return patched(scene_mod, name, wrapped)
    stage = {'now': 'scene'}
    with contextlib.ExitStack() as es:
        es.enter_context(timed('build_bvh', 'bvh'))
        for name in ('thread_bvh', 'build_wide_bvh', 'build_world_bvh',
                     'build_world_wide', 'split_packet_tables',
                     'build_merged_table'):
            es.enter_context(timed(name, 'tables'))
        t = time.perf_counter()
        scene = builder.get_scene('2mtris')
        t_scene = time.perf_counter() - t
        stage['now'] = 'upload'
        t = time.perf_counter()
        pt = Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
        torch.cuda.synchronize()
        t_upload = time.perf_counter() - t
    bvh_s = spent.get(('scene', 'bvh'), 0.0)
    tables_s = sum(v for (_, part), v in spent.items() if part == 'tables')
    mesh_s = t_scene - bvh_s - spent.get(('scene', 'tables'), 0.0)
    upload_s = t_upload - spent.get(('upload', 'tables'), 0.0) \
        - spent.get(('upload', 'bvh'), 0.0)
    merged = pt.dyn.packet_merged
    n_tris = len(scene._tri_mat)
    log(f'scene: 2mtris {n_tris} triangles; build on the host by part: mesh '
        f'{mesh_s:.2f} s, BVH {bvh_s:.2f} s ({native_route()}), wide collapse '
        f'and tables {tables_s:.2f} s, to_device {upload_s:.2f} s; merged '
        f'table {merged.shape[0]} rows x {merged.shape[1] * 4} B = '
        f'{merged.nbytes / 1e6:.1f} MB, split {pt.dyn.packet_inner.shape[0]} '
        f'inner + {pt.dyn.packet_leaf.shape[0]} leaf rows, depth '
        f'{pt.dyn.depth}')
    if n_tris < 2_000_000:
        failures.append(f'2mtris: {n_tris} triangles')
    cam = Camera.create(*STATUE_CAMERA, device='cuda')
    run = converge(pt, cam, 2, '2mtris', SIBENIK_KERNELS, failures)
    counts['2mtris'] = run['launches']
    hold_converge_waves('traverse 2mtris', run, failures, sib_waves)
    del run
    rays0 = int(pt.rays_traced)
    shares = profiling.device_op_shares(lambda: pt.render(cam))
    rays = int(pt.rays_traced) - rays0
    busy = shares['_busy_ms']
    trav = sum(ms for name, ms in shares['_kernels']
               if profiling.categorize_kernel(name).startswith('traverse'))
    log(f'2mtris converge sample (profiled): {rays} rays, busy {busy:.2f} ms, '
        f'{rays / busy / 1e3:.2f} Mrays/s over busy time; traversal '
        f'{trav:.3f} ms ({trav / busy:.3f} of busy)')
    del pt
    torch.cuda.empty_cache()

    # (b) 2mtris, Whitted: one depth-7 frame, level 0 held on v2 and v1
    kernels.reset_counts()
    rt = rt_mod.Raytracer(scene, WIDTH, HEIGHT, device='cuda')
    whitted_frame(rt, cam, False, '2mtris v2 depth 7', failures)
    hold_level0(rt, cam, '2mtris v2 depth 7', failures)
    dispatch_mod.PACKET_V1 = True
    try:
        hold_level0(rt, cam, '2mtris v1 depth 7', failures)
    finally:
        dispatch_mod.PACKET_V1 = False
    torch.cuda.synchronize()
    counts['2mtris-whitted'] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if kernels.LAUNCHES['traverse'] <= 0 or \
            kernels.LAUNCHES['traverse_packet'] <= 0:
        failures.append(f'2mtris Whitted: launches {kernels.LAUNCHES}')
    del rt, scene
    torch.cuda.empty_cache()

    # (c) a .chai script through the CLI, and its twin in process
    from _torch_room import write_cube_obj
    write_cube_obj(tmp)
    script, state = os.path.join(tmp, 's.chai'), os.path.join(tmp, 'chai.txt')
    with open(script, 'w') as f:
        f.write(CHAI_SCRIPT)
    with open(state, 'w') as f:
        f.write(CHAI_STATE)
    args = ['--scene', script, '--width', str(WIDTH), '--height', str(HEIGHT),
            '--spp', '2', '--blur', '--device', 'cuda', '--asset-dir', tmp,
            '--state', state, '--out', os.path.join(tmp, 'chai.png')]
    kernels.reset_counts()
    t = time.perf_counter()
    rc, text, app, _ = run_cli(cli_main, args, False)
    torch.cuda.synchronize()
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    counts['chai'] = got
    m = re.search(r'^energy (\S+) nan=(\w+) neg=(\w+)$', text, re.M)
    log(f'cli --scene s.chai: rc={rc}, {time.perf_counter() - t:.2f} s wall; '
        f'launches {got}')
    if rc != 0 or m is None or not (0 < float(m.group(1)) < float('inf')) \
            or m.group(2) != 'False' or m.group(3) != 'False':
        failures.append(f'cli --scene s.chai: rc={rc}, '
                        f'{m.group(0) if m else "no energy line"}')
    for name in ('traverse', 'blur'):
        if got.get(name, 0) <= 0:
            failures.append(f'cli --scene s.chai: {name} did not launch')
    if any(kernels.PLAIN_ON_CUDA.values()):
        failures.append(f'cli --scene s.chai: plain versions on CUDA '
                        f'{kernels.PLAIN_ON_CUDA}')
    cli_img = app.image(blur=True)
    del app
    scene = chai_twin(tmp)
    camera = state_mod.read_state(state, device='cuda')
    twin = Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    scene.update(None, 0.0)
    twin.render(camera, 0.0, 0.0, should_clear=True)
    while twin.sample_idx < 2:
        twin.render(camera, 0.0, 0.0, should_clear=False)
    twin.finish()
    img = twin.image(blur=True)
    diff = int((img.view(torch.int32) != cli_img.view(torch.int32)).any(
        dim=-1).sum())
    log(f'cli --scene s.chai vs its twin built through the Scene API: '
        f'{len(scene._tri_mat)} triangles, {diff} of {WIDTH * HEIGHT} pixels '
        f'differ (bit for bit)')
    if diff:
        failures.append(f'cli --scene s.chai: {diff} pixels differ from '
                        f'its twin')
    del twin, scene
    torch.cuda.empty_cache()
    return counts


SHARD_FRAMES = (True, False, False)    # a clear frame, 2 converge samples
JPEG_DIR = 'tests/data/jpeg'


def _sample_times(pt, cam, clear: bool):
    """Render one frame; returns (host wall ms, CUDA-event ms) around it."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    ms, _ = cuda_ms(lambda: pt.render(cam, should_clear=clear))
    return (time.perf_counter() - t) * 1e3, ms


def shard_rank(rank: int, world: int, store: str, out: str,
               cards: bool = False):
    """One spawned rank of phase 6b (or of ``--cards``): sibenik at
    1920x1080 sharded over ``world`` ranks, on card ``rank`` when ``cards``
    (NCCL) else all on card 0 (gloo), SHARD_FRAMES, the blurred image, then
    one profiled converge sample. Rank 0 saves the gathered lane-order
    accumulators after every frame; every rank saves its launches, its
    sample times and its busy time to ``out/rank{r}.pt``."""
    sys.modules['jax'] = None
    import torch
    from cuda_pathtracer_tpu_torch.core.camera import Camera
    from cuda_pathtracer_tpu_torch.ops import kernels
    from cuda_pathtracer_tpu_torch.parallel import mesh
    from cuda_pathtracer_tpu_torch.scene import builder
    from cuda_pathtracer_tpu_torch.utils import profiling
    device = f'cuda:{rank}' if cards else 'cuda:0'
    torch.cuda.set_device(device)
    kernels.library()
    group = mesh.init_group(device, rank, world, store)
    res = {'rank': rank, 'backend': group.backend, 'ridx': [], 'times': []}
    try:
        scene = builder.get_scene('sibenik')
        pt = mesh.ShardedPathtracer(scene, WIDTH, HEIGHT, group=group)
        res['geometry'] = (pt.height, pt.bands, pt.band_h, pt.tile_order,
                           list(pt._owned_bands()))
        cam = Camera.create(*SIBENIK_CAMERA, device=device)
        kernels.reset_counts()
        for i, clear in enumerate(SHARD_FRAMES):
            res['times'].append(_sample_times(pt, cam, clear))
            res['ridx'].append(pt.rand_idx)
            lum, alb = pt.gather_lanes()
            if rank == 0:
                res[f'lum{i}'], res[f'alb{i}'] = lum.cpu(), alb.cpu()
                res[f'cache{i}'] = pt.radiance.cache.cpu()
            del lum, alb
        img = pt.image(blur=True)
        torch.cuda.synchronize()
        res['launches'] = dict(kernels.LAUNCHES)
        res['plain'] = dict(kernels.PLAIN_ON_CUDA)
        if rank == 0:
            res['image_finite'] = bool(torch.isfinite(img).all())
        res['busy_ms'] = profiling.device_op_shares(
            lambda: pt.render(cam))['_busy_ms']
        res['jax'] = sorted(
            m for m in sys.modules if sys.modules[m] is not None and (
                m in ('jax', 'cuda_pathtracer_tpu')
                or m.startswith(('jax.', 'cuda_pathtracer_tpu.'))))
    finally:
        mesh.close_group()
    torch.save(res, os.path.join(out, f'rank{rank}.pt'))


def check_launches(tag, got, plain, need, failures: list):
    """Every kernel of ``need`` launched, no plain version ran on CUDA."""
    plain = {k: v for k, v in plain.items() if v}
    log(f'  {tag}: launches {got}; plain versions on CUDA {plain}')
    for name in need:
        if got.get(name, 0) <= 0:
            failures.append(f'{tag}: {name} never launched')
    if any(plain.values()):
        failures.append(f'{tag}: plain versions ran on CUDA: {plain}')


def snapshots(pt, cam, frames):
    """Render ``frames``; per frame the times, counters and state."""
    out = []
    for clear in frames:
        times = _sample_times(pt, cam, clear)
        out.append(dict(times=times, ridx=pt.rand_idx, sidx=pt.sample_idx,
                        lum=pt.lum.cpu(), alb=pt.alb.cpu(),
                        cache=pt.radiance.cache.cpu(),
                        total=pt.radiance.total.cpu()))
    return out


def per_sample(snaps):
    """(host wall ms, CUDA-event ms) per converge sample of ``snaps``."""
    conv = [s['times'] for s in snaps[1:]]
    return (sum(w for w, _ in conv) / len(conv),
            sum(e for _, e in conv) / len(conv))


def spawn_shard(tmp: str, world: int, cards: bool, failures: list, tag: str):
    """``shard_rank`` in ``world`` spawned processes; their results (None
    when a rank failed) and the seconds it took."""
    import multiprocessing as mp
    import torch
    out = os.path.join(tmp, f'ranks-{world}-{cards}')
    os.makedirs(out)
    ctx = mp.get_context('spawn')
    store = os.path.join(tmp, f'store-{world}-{cards}')
    procs = [ctx.Process(target=shard_rank, args=(r, world, store, out, cards))
             for r in range(world)]
    t = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
        if p.is_alive():
            p.kill()
            p.join()
    spent = time.perf_counter() - t
    codes = [p.exitcode for p in procs]
    if any(codes):
        failures.append(f'{tag}: rank exit codes {codes}')
        return None, spent
    return [torch.load(os.path.join(out, f'rank{r}.pt'))
            for r in range(world)], spent


def hold_shard(tag: str, ranks: list, want: list, geometry: tuple,
               backend: str, failures: list, counts: dict):
    """Hold spawned ranks to the single engine at their geometry (``want``,
    SHARD_FRAMES): ``lum`` bit-equal after the clear frame and the first
    converge sample, ``rand_idx`` equal, the radiance cache within rtol 1e-4
    / atol 1e-5, after the second sample the weight channel equal and the
    mean within 2%; every rank on ``backend`` at ``geometry`` (height,
    bands, band_h, tile order), the path's kernels launched. Returns the
    ranks' (wall, CUDA-event) ms per converge sample."""
    import torch
    r0 = ranks[0]
    ridx_ok = all(r['ridx'] == [w['ridx'] for w in want] for r in ranks)
    bit = [torch.equal(r0[f'lum{i}'], want[i]['lum']) for i in (0, 1)]
    cache_ok = torch.allclose(r0['cache1'], want[1]['cache'], rtol=1e-4,
                              atol=1e-5)
    cache_d = float((r0['cache1'] - want[1]['cache']).abs().max())
    w_ok = torch.equal(r0['lum2'][:, 3], want[2]['lum'][:, 3])
    mean = float(r0['lum2'][:, :3].mean() / want[2]['lum'][:, :3].mean())
    log(f'{tag}: {len(ranks)} ranks on {[r["backend"] for r in ranks]}, '
        f'geometry {[r["geometry"] for r in ranks]}; rand_idx {r0["ridx"]} '
        f'(single {[w["ridx"] for w in want]}); lum bit-equal after the '
        f'clear frame and the first converge sample {bit}; radiance cache '
        f'max|d| {cache_d:.3g} (rtol 1e-4, atol 1e-5: {cache_ok}); after '
        f'the second: weight equal {w_ok}, mean ratio {mean:.6f}')
    for r in ranks:
        need = SIBENIK_KERNELS if r['rank'] == 0 else \
            ('traverse', 'guiding_scatter')
        got = {k: v for k, v in r['launches'].items() if v}
        check_launches(f'{tag} rank {r["rank"]}', got, r['plain'], need,
                       failures)
        counts[f'{tag} rank {r["rank"]}'] = got
        if r['jax']:
            failures.append(f'{tag} rank {r["rank"]} imported {r["jax"]}')
    if not (ridx_ok and all(bit) and cache_ok and w_ok
            and abs(mean - 1) < 0.02 and r0['image_finite']
            and all(r['backend'] == backend and tuple(r['geometry'][:4])
                    == geometry for r in ranks)):
        failures.append(f'{tag}: the ranks disagree with the single engine')
    return ([sum(w for w, _ in r['times'][1:]) / 2 for r in ranks],
            [sum(e for _, e in r['times'][1:]) / 2 for r in ranks])


def run_shard(tmp: str, failures: list) -> dict:
    """Phase 6: ``--shard`` and JPEG on the card. (a) a world of one rank on
    NCCL in this process, held bit for bit to the single engine; (b) two
    spawned ranks sharing the card on gloo, held to the single engine at
    their geometry; (c) the CLI with and without ``--shard``; (d) the JPEG
    fixtures against PIL's digests and a JPEG sky on outside. Returns
    {run: launches}."""
    import hashlib
    import subprocess
    import torch
    from cuda_pathtracer_tpu_torch.core.camera import Camera
    from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu_torch.ops import kernels
    from cuda_pathtracer_tpu_torch.parallel import mesh
    from cuda_pathtracer_tpu_torch.scene import builder
    from cuda_pathtracer_tpu_torch.scene.jpeg import decode_jpeg
    from cuda_pathtracer_tpu_torch.scene.textures import load_image
    from cuda_pathtracer_tpu_torch.utils import profiling
    counts = {}
    cam = Camera.create(*SIBENIK_CAMERA, device='cuda')

    # (a) a world of one rank on NCCL, in this process, at the default
    # geometry (5 bands of 216 rows)
    scene = builder.get_scene('sibenik')
    single = Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    want = snapshots(single, cam, SHARD_FRAMES)
    group = mesh.init_group('cuda:0', 0, 1, os.path.join(tmp, 'store-a'))
    try:
        pt = mesh.ShardedPathtracer(scene, WIDTH, HEIGHT, group=group)
        geo = (pt.height, pt.bands, pt.band_h, pt.tile_order)
        kernels.reset_counts()
        got = snapshots(pt, cam, SHARD_FRAMES)
        img = pt.image(blur=True)
        torch.cuda.synchronize()
        counts['6a'] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        check_launches('6a', counts['6a'], dict(kernels.PLAIN_ON_CUDA),
                       SIBENIK_KERNELS, failures)
        busy_a = profiling.device_op_shares(lambda: pt.render(cam))['_busy_ms']
        # two more converge samples of each engine, in turns (the host's
        # clock drifts between runs on this machine)
        turns = {'single': [], 'one rank': []}
        for _ in range(2):
            turns['single'].append(_sample_times(single, cam, False))
            turns['one rank'].append(_sample_times(pt, cam, False))
        backend = group.backend
    finally:
        mesh.close_group()
    same = all(g['ridx'] == w['ridx'] and g['sidx'] == w['sidx'] and all(
        torch.equal(g[k], w[k]) for k in ('lum', 'alb', 'cache', 'total'))
        for g, w in zip(got, want))
    wall1, ev1 = per_sample(got)
    turns = {k: [round(w, 1) for w, _ in v] for k, v in turns.items()}
    log(f'phase 6a: world of one on {backend}, {geo[1]} bands of {geo[2]} '
        f'rows (tile order {geo[3]}); rand_idx {[g["ridx"] for g in got]}; '
        f'lum, alb, radiance and rand_idx bit-equal to the single engine '
        f'after every frame: {same}; converge sample {wall1:.1f} ms wall, '
        f'{ev1:.1f} ms CUDA events, busy {busy_a:.1f} ms (single engine '
        f'{per_sample(want)[0]:.1f} ms wall); in turns, ms wall per sample '
        f'{turns}')
    if backend != 'nccl' or geo != (HEIGHT, 5, 216, True) or not same:
        failures.append(f'6a: backend {backend}, geometry {geo}, bit-equal '
                        f'{same}')
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(
            torch.isfinite(img).all()):
        failures.append('6a: the blurred image is not finite [1080, 1920, 3]')
    del pt, single, got, want, img
    torch.cuda.empty_cache()

    # (b) two ranks sharing the card (gloo), against the single engine at
    # their geometry: 6 bands of 180 rows, tile order off
    height, bands = mesh.mesh_geometry(WIDTH, HEIGHT, 5, 2)
    single = Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    single._set_bands(bands)
    want = snapshots(single, cam, SHARD_FRAMES)
    del single, scene
    torch.cuda.empty_cache()
    ranks, spent = spawn_shard(tmp, 2, False, failures, '6b')
    if ranks is not None:
        log(f'phase 6b: {spent:.1f} s with the spawn and the scene builds')
        walls, evs = hold_shard('phase 6b', ranks, want,
                                (height, bands, 180, False), 'gloo',
                                failures, counts)
        wall_s, ev_s = per_sample(want)
        log(f'  ms per converge sample: 2 ranks wall {walls}, CUDA events '
            f'{evs}, busy {[r["busy_ms"] for r in ranks]}; single engine '
            f'at 6 bands wall {wall_s:.1f}, CUDA events {ev_s:.1f}; one '
            f'rank (6a, 5 bands) wall {wall1:.1f}, CUDA events {ev1:.1f}, '
            f'busy {busy_a:.1f}')

    # (c) the CLI: --shard (one card: a world of one) against no --shard,
    # both at once
    runs = {}
    for tag, extra in (('plain', []), ('shard', ['--shard'])):
        state = os.path.join(tmp, f'cli-{tag}.txt')
        with open(state, 'w') as f:
            f.write(OUTSIDE_STATE)
        png = os.path.join(tmp, f'cli-{tag}.png')
        runs[tag] = (png, subprocess.Popen(
            [sys.executable, '-m', 'cuda_pathtracer_tpu_torch', *OUTSIDE_ARGS,
             '--out', png, '--state', state, *extra], cwd=tmp,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.dirname(
                os.path.abspath(__file__)))))
    pngs = {}
    t = time.perf_counter()
    for tag, (png, proc) in runs.items():
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        lines = [ln for ln in err.splitlines()
                 if ln.startswith(('shard:', 'rendered', 'energy'))]
        log(f'phase 6c {tag}: rc={proc.returncode}; {lines}')
        if proc.returncode:
            failures.append(f'6c {tag}: rc {proc.returncode}: {err[-1500:]}')
            continue
        with open(png, 'rb') as f:
            pngs[tag] = f.read()
    same = len(pngs) == 2 and pngs['plain'] == pngs['shard']
    if not same:
        failures.append('6c: the --shard PNG differs from the plain one')
    log(f'phase 6c: {time.perf_counter() - t:.1f} s for both; the PNG with '
        f'--shard equals the PNG without: {same}')

    # (d) JPEG: the fixtures against PIL's digests, then a JPEG sky
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, JPEG_DIR, 'digests.json')) as f:
        digests = json.load(f)
    bad = []
    t = time.perf_counter()
    for name, d in sorted(digests.items()):
        with open(os.path.join(here, JPEG_DIR, name), 'rb') as f:
            px = decode_jpeg(f.read())
        if list(px.shape) != d['shape'] or \
                hashlib.sha256(px.tobytes()).hexdigest() != d['sha256']:
            bad.append(name)
    log(f'phase 6d: {len(digests) - len(bad)} of {len(digests)} JPEG '
        f'fixtures decode to PIL\'s digests ({time.perf_counter() - t:.2f} '
        f's, the decoder build included)')
    if bad:
        failures.append(f'6d: JPEG decodes differ from PIL: {bad}')
    sky_dir = os.path.join(tmp, 'sky')
    os.makedirs(sky_dir)
    sky = os.path.join(sky_dir, 'skydome.jpg')
    with open(os.path.join(here, JPEG_DIR, 'sky_256x128.jpg'), 'rb') as f, \
            open(sky, 'wb') as g:
        g.write(f.read())
    out_cam = Camera.create([0.0, 4.0, -17.0], [0.0, -0.2, 1.0], 1.5, 12.0,
                            0.02, device='cuda')
    imgs = {}
    no_sky = os.path.join(tmp, 'no-sky')
    os.makedirs(no_sky)
    for tag, dirs in (('jpeg', [sky_dir]), ('grey', [no_sky])):
        pt = Pathtracer(builder.get_scene('outside', asset_dirs=dirs), WIDTH,
                        HEIGHT, device='cuda')
        if tag == 'jpeg':
            sky_ok = torch.equal(pt.arrays.sky_img.cpu(),
                                 torch.from_numpy(load_image(sky)))
        pt.render(out_cam, 5.0, should_clear=True)
        imgs[tag] = pt.image().cpu()
        del pt
    differs = float((imgs['jpeg'] - imgs['grey']).abs().max())
    log(f'phase 6d: outside {WIDTH}x{HEIGHT} with skydome.jpg: sky_img '
        f'equals the '
        f'decode: {sky_ok}; image max|d| against the grey sky {differs:.4f}')
    if not sky_ok or not differs > 0:
        failures.append('6d: the JPEG sky did not load or did not show')
    return counts


IMAGE_DIR = 'tests/data/images'
# phase 7's real sizes: a 4096x2048 sky, 2048x2048 textures
SKY_W, SKY_H, TEX = 4096, 2048, 2048
QUAD_OBJ = ('mtllib quad.mtl\nv -2 0 0\nv 2 0 0\nv 2 3 0\nv -2 3 0\n'
            'vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl painted\n'
            'f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n')
QUAD_MTL = 'newmtl painted\nKd 0.9 0.9 0.9\nmap_Kd tex.tga\nnorm nrm.bmp\n'
QUAD_CAMERA = ([0.5, 1.5, -6.0], [0.0, 0.1, 1.0], 1.5, 6.0, 0.0)


def quad_room(scene_mod, asset_dir: str):
    """The quad room of ``tests/test_torch_images.py``: a quad with the
    MTL's ``map_Kd`` and ``norm`` over a plane."""
    s = scene_mod.Scene(asset_dirs=[asset_dir])
    white = s.add_material(scene_mod.Material.DIFFUSE((0.9, 0.9, 0.9)))
    s.add_object(scene_mod.GameObject(s.add_model('quad.obj', 1.0, (0, 0, 0),
                                                  (0, 0, 0), white, True)))
    s.add_plane(scene_mod.Plane((0.0, 1.0, 0.0), 0.0, white))
    s.finalize()
    return s


def run_images(card: str, tmp: str, failures: list) -> dict:
    """Phase 7: image decoding. (a) every fixture of ``tests/data/images``
    to the digests PIL wrote (mode, shape, SHA-256); (b) a 4096x2048 RGB
    PNG sky whose rows cycle through the five filter types, the same sky
    Adam7-interlaced, a 2048x2048 RLE RGBA TGA and a 2048x2048 8-bit
    palette BMP, encoded here from seeded arrays (``tests/_torch_images.py``)
    and decoded equal to them, with each one's host decode seconds; (c)
    ``outside`` at 1920x1080 with the PNG as its sky (a clear frame, 2
    samples, the blurred image) against the grey sky, and the quad room at
    1920x1080 with the TGA as ``map_Kd`` and the BMP as ``norm``, each with
    its launch counts set to 0 just before it; (d) a palette PNG sky loads
    and a truncated one raises. Returns {run: launches}."""
    import hashlib
    import numpy as np
    import torch
    import _torch_images as ti
    from cuda_pathtracer_tpu_torch.core.camera import Camera
    from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu_torch.ops import kernels
    from cuda_pathtracer_tpu_torch.scene import builder, images
    from cuda_pathtracer_tpu_torch.scene import scene as scene_mod
    from cuda_pathtracer_tpu_torch.scene.textures import load_image
    here = os.path.dirname(os.path.abspath(__file__))
    counts = {}

    # (a) the fixtures against PIL's digests
    with open(os.path.join(here, IMAGE_DIR, 'digests.json')) as f:
        manifest = json.load(f)
    digests, bad = manifest['files'], []
    t = time.perf_counter()
    for name, d in sorted(digests.items()):
        with open(os.path.join(here, IMAGE_DIR, name), 'rb') as f:
            px, mode = images.decode_image(f.read(), name)
        if (mode, list(px.shape), hashlib.sha256(px.tobytes()).hexdigest()) \
                != (d['mode'], d['shape'], d['sha256']):
            bad.append(name)
    log(f'phase 7a: {len(digests) - len(bad)} of {len(digests)} image '
        f'fixtures decode to the digests of Pillow {manifest["pillow"]} '
        f'({time.perf_counter() - t:.2f} s, the decoder build included)')
    if bad:
        failures.append(f'7a: image decodes differ from PIL: {bad}')

    # (b) real sizes, from seeded arrays through the in-repo encoders
    sky = ti.picture(SKY_H, SKY_W, 3, seed=70)
    tex = ti.picture(TEX, TEX, 4, seed=71, runs=4)
    idx = ti.picture(TEX, TEX, 1, seed=72)[..., 0]
    palette = np.random.RandomState(73).randint(0, 256, (256, 3)).astype(
        np.uint8)
    files = {
        'sky.png': (ti.encode_png(sky, 8, 2), sky),
        'sky_adam7.png': (ti.encode_png(sky, 8, 2, interlace=True), sky),
        'tex.tga': (ti.encode_tga(tex[..., [2, 1, 0, 3]], 10, 32), tex),
        'nrm.bmp': (ti.encode_bmp(idx, 8, palette), palette[idx]),
    }
    decodes = {}
    for name, (data, want) in files.items():
        with open(os.path.join(tmp, name), 'wb') as f:
            f.write(data)
        t = time.perf_counter()
        px, mode = images.decode_image(data, name)
        secs = time.perf_counter() - t
        decodes[name] = px
        ok = px.shape == want.shape and np.array_equal(px, want)
        log(f'phase 7b: {name} {want.shape[1]}x{want.shape[0]} {mode}, '
            f'{len(data)} bytes: host decode {secs:.4f} s, equal to its '
            f'source: {ok} | {card}')
        if not ok:
            failures.append(f'7b: {name} does not decode to its source')

    # (c) renders: the PNG sky on outside against the grey sky, and the
    # quad room with the TGA map_Kd and the BMP norm
    cam = Camera.create([0.0, 4.0, -17.0], [0.0, -0.2, 1.0], 1.5, 12.0, 0.02,
                        device='cuda')
    no_sky = os.path.join(tmp, 'no-sky')
    os.makedirs(no_sky)
    imgs, energy = {}, {}
    for tag, dirs, sky_name in (('png', [tmp], 'sky.png'),
                                ('grey', [no_sky], None)):
        pt = Pathtracer(builder.get_scene('outside', asset_dirs=dirs), WIDTH,
                        HEIGHT, device='cuda', skydome=sky_name)
        if tag == 'png':
            sky_ok = torch.equal(pt.arrays.sky_img.cpu(), torch.from_numpy(
                load_image(os.path.join(tmp, 'sky.png'))))
        kernels.reset_counts()
        for clear in (True, False, False):
            pt.render(cam, 5.0, should_clear=clear)
        imgs[tag] = pt.image(blur=True).cpu()
        torch.cuda.synchronize()
        counts[f'7c {tag}'] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        check_launches(f'7c outside, {tag} sky', counts[f'7c {tag}'],
                       dict(kernels.PLAIN_ON_CUDA), ('traverse', 'blur'),
                       failures)
        energy[tag] = pt.energy()
        del pt
    differs = float((imgs['png'] - imgs['grey']).abs().max())
    log(f'phase 7c: outside {WIDTH}x{HEIGHT} with the {SKY_W}x{SKY_H} PNG '
        f'sky: sky_img equals the decode: {sky_ok}; energy {energy["png"]} '
        f'(grey sky {energy["grey"]}); image max|d| against the grey sky '
        f'{differs:.4f}')
    e, nan, neg = energy['png']
    if not sky_ok or not differs > 0 or not np.isfinite(e) or nan or \
            e == energy['grey'][0]:
        failures.append('7c: the PNG sky did not load or did not show')
    with open(os.path.join(tmp, 'quad.obj'), 'w') as f:
        f.write(QUAD_OBJ)
    with open(os.path.join(tmp, 'quad.mtl'), 'w') as f:
        f.write(QUAD_MTL)
    pt = Pathtracer(quad_room(scene_mod, tmp), WIDTH, HEIGHT, device='cuda',
                    skydome='sky_adam7.png')
    texels = pt.arrays.textures.texels.cpu().numpy()
    want = np.concatenate([
        (decodes[n][..., :3][::-1].astype(np.float32) / 255.0).reshape(-1, 3)
        for n in ('tex.tga', 'nrm.bmp')])
    tex_ok = texels.shape == want.shape and np.array_equal(texels, want)
    kernels.reset_counts()
    qcam = Camera.create(*QUAD_CAMERA, device='cuda')
    for clear in (True, False, False):
        pt.render(qcam, should_clear=clear)
    img = pt.image(blur=True)
    torch.cuda.synchronize()
    counts['7c quad'] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check_launches('7c quad room', counts['7c quad'],
                   dict(kernels.PLAIN_ON_CUDA), ('traverse', 'blur'), failures)
    e, nan, neg = pt.energy()
    log(f'phase 7c: quad room {WIDTH}x{HEIGHT}, TGA map_Kd and BMP norm '
        f'({TEX}x{TEX} each): texels equal the decodes: {tex_ok}; energy {e} '
        f'(NaN {nan}, negative {neg}); image finite '
        f'{bool(torch.isfinite(img).all())}')
    if not tex_ok or not np.isfinite(e) or not e > 0 or nan:
        failures.append('7c: the quad room\'s textures did not load or it '
                        'rendered no energy')
    del pt, img

    # (d) ROADMAP C.9 on the card: a palette PNG sky loads, a truncated
    # one raises instead of leaving the grey sky
    pal_png = ti.encode_png(idx[:256, :512, None] % 64, 8, 3,
                            palette=palette[:64])
    c9 = os.path.join(tmp, 'c9')
    os.makedirs(c9)
    with open(os.path.join(c9, 'quad.obj'), 'w') as f:
        f.write(QUAD_OBJ.replace('mtllib quad.mtl\n', '').replace(
            'usemtl painted\n', ''))
    with open(os.path.join(c9, 'sky.png'), 'wb') as f:
        f.write(pal_png)
    pt = Pathtracer(quad_room(scene_mod, c9), 64, 48, device='cuda',
                    skydome='sky.png')
    loaded = torch.equal(pt.arrays.sky_img.cpu(), torch.from_numpy(
        (palette[:64][idx[:256, :512] % 64][::-1].astype(np.float32) / 255.0)))
    del pt
    with open(os.path.join(c9, 'sky.png'), 'wb') as f:
        f.write(pal_png[:len(pal_png) // 2])
    try:
        Pathtracer(quad_room(scene_mod, c9), 64, 48, device='cuda',
                   skydome='sky.png')
        raised = 'nothing'
    except OSError as e:
        raised = f'OSError ({e})'
    log(f'phase 7d: a palette PNG sky loads as its palette colours: {loaded};'
        f' a truncated one raises {raised}')
    if not loaded or not raised.startswith('OSError'):
        failures.append('7d: the palette sky did not load, or the truncated '
                        'one did not raise')

    # (e) the files the port once refused, at sky size, then the
    # arithmetic-coded one as outside's skydome.jpg
    run_refused_images(card, tmp, imgs['grey'], energy['grey'], counts,
                       failures)
    torch.cuda.empty_cache()
    return counts


def run_refused_images(card: str, tmp: str, grey_img, grey_energy,
                       counts: dict, failures: list):
    """Phase 7e: a 4096x2048 progressive arithmetic-coded JPEG sky (a
    smooth picture, restart markers every 64 MCUs), a 1024x512 CMYK JPEG
    with an Adobe marker and a 4096x2048 PackBits RGB PSD, encoded here from
    seeded arrays (``tests/_torch_jpeg.py``, ``tests/_torch_images.py``).
    The PSD must decode to its array; each JPEG to the decode of a second
    file of the same quantized coefficients through another entropy coder
    (a sequential arithmetic one, a Huffman one), and within 24 of its
    array (the loss of quantization). Each host decode's seconds are
    printed beside the card. Then ``outside`` at 1920x1080 with the
    arithmetic file as ``skydome.jpg``: a clear frame, 2 samples, the
    blurred image; ``sky_img`` equals the decode, the energy is finite and
    unlike the grey sky's; launch counts set to 0 just before,
    ``traverse`` and ``blur`` required."""
    import numpy as np
    import torch
    import _torch_images as ti
    import _torch_jpeg as tj
    from cuda_pathtracer_tpu_torch.core.camera import Camera
    from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu_torch.ops import kernels
    from cuda_pathtracer_tpu_torch.scene import builder, images
    from cuda_pathtracer_tpu_torch.scene.jpeg import decode_jpeg
    from cuda_pathtracer_tpu_torch.scene.textures import load_image
    t = time.perf_counter()
    sky = tj.smooth_picture(SKY_H, SKY_W, seed=75)
    blocks = tj.quantized(sky, tj.F420)
    arith = tj.encode_arithmetic(sky, tj.F420, progressive=True, restart=64,
                                 blocks=blocks)
    arith_seq = tj.encode_arithmetic(sky, tj.F420, blocks=blocks)
    cmyk_src = tj.smooth_picture(512, 1024, seed=76, c=4)
    cmyk = tj.encode_baseline(cmyk_src, [(1, 1)] * 4, adobe=True)
    cmyk_arith = tj.encode_arithmetic(cmyk_src, [(1, 1)] * 4, adobe=True)
    psd_src = ti.picture(SKY_H, SKY_W, 3, seed=77, runs=4)
    psd = ti.encode_psd(np.ascontiguousarray(psd_src.transpose(2, 0, 1)),
                        'rgb', 1)
    log(f'phase 7e: encoded from seeded arrays in '
        f'{time.perf_counter() - t:.1f} s (host)')
    cases = {
        'sky_arith.jpg': (arith, sky, lambda: decode_jpeg(arith_seq)),
        'cmyk.jpg': (cmyk, cmyk_src, lambda: decode_jpeg(cmyk_arith)),
        'sky.psd': (psd, psd_src, None),
    }
    for name, (data, src, other) in cases.items():
        t = time.perf_counter()
        px, mode = images.decode_image(data, name)
        secs = time.perf_counter() - t
        if other is None:
            ok = px.shape == src.shape and np.array_equal(px, src)
            how = 'equal to its array'
        else:
            raw = decode_jpeg(data)
            if mode == 'CMYK':    # PIL's CMYK;I: the file's samples inverted
                raw = 255 - raw
            err = int(np.abs(raw.astype(np.int32) - src).max())
            same = bool(np.array_equal(decode_jpeg(data), other()))
            ok = same and err <= 24 and px.shape[-1] == 3
            how = (f'equal to the other coder\'s decode: {same}, max |d| '
                   f'from its array {err}')
        log(f'phase 7e: {name} {src.shape[1]}x{src.shape[0]} {mode}, '
            f'{len(data)} bytes: host decode {secs:.4f} s, {how}: {ok} | '
            f'{card}')
        if not ok:
            failures.append(f'7e: {name} does not decode as it should')
    sky_dir = os.path.join(tmp, 'arith-sky')
    os.makedirs(sky_dir)
    path = os.path.join(sky_dir, 'skydome.jpg')
    with open(path, 'wb') as f:
        f.write(arith)
    cam = Camera.create([0.0, 4.0, -17.0], [0.0, -0.2, 1.0], 1.5, 12.0, 0.02,
                        device='cuda')
    pt = Pathtracer(builder.get_scene('outside', asset_dirs=[sky_dir]), WIDTH,
                    HEIGHT, device='cuda')
    sky_ok = torch.equal(pt.arrays.sky_img.cpu(),
                         torch.from_numpy(load_image(path)))
    kernels.reset_counts()
    for clear in (True, False, False):
        pt.render(cam, 5.0, should_clear=clear)
    img = pt.image(blur=True).cpu()
    torch.cuda.synchronize()
    counts['7e arith sky'] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check_launches('7e outside, arithmetic sky', counts['7e arith sky'],
                   dict(kernels.PLAIN_ON_CUDA), ('traverse', 'blur'), failures)
    e, nan, neg = pt.energy()
    differs = float((img - grey_img).abs().max())
    log(f'phase 7e: outside {WIDTH}x{HEIGHT} with the {SKY_W}x{SKY_H} '
        f'arithmetic-coded progressive skydome.jpg: sky_img equals the '
        f'decode: {sky_ok}; energy {e} (NaN {nan}, negative {neg}; grey sky '
        f'{grey_energy[0]}); image max|d| against the grey sky {differs:.4f}')
    if not sky_ok or not np.isfinite(e) or nan or e == grey_energy[0] or \
            not differs > 0:
        failures.append('7e: the arithmetic JPEG sky did not load or did not '
                        'show')
    del pt, img


def run_cards(n: int, tmp: str, failures: list) -> dict:
    """``--cards N``: ``--shard`` across N cards of one host, one rank per
    card, on NCCL. (1) N spawned ranks (``shard_rank``, card r for rank r)
    held to the single engine at their geometry as phase 6b holds two
    ranks; (2) the CLI twice: ``--shard`` starting its own ranks (one per
    visible card) and N processes in torchrun's environment that each see
    only their own card as ``cuda:0``; both must choose NCCL, and their
    PNGs must agree on 99% of the pixels to one level."""
    import subprocess
    import torch
    from cuda_pathtracer_tpu_torch.core.camera import Camera
    from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu_torch.parallel import mesh
    from cuda_pathtracer_tpu_torch.scene import builder
    from cuda_pathtracer_tpu_torch.utils.image import decode_png
    counts = {}
    if torch.cuda.device_count() < n:
        failures.append(f'--cards {n}: {torch.cuda.device_count()} cards')
        return counts
    single = Pathtracer(builder.get_scene('sibenik'), WIDTH, HEIGHT,
                        device='cuda')
    height, bands = mesh.mesh_geometry(WIDTH, HEIGHT, single.bands, n)
    single._set_bands(bands)
    want = snapshots(single, Camera.create(*SIBENIK_CAMERA, device='cuda'),
                     SHARD_FRAMES)
    del single
    torch.cuda.empty_cache()
    ranks, spent = spawn_shard(tmp, n, True, failures, 'cards')
    if ranks is not None:
        log(f'cards: {spent:.1f} s with the spawn and the scene builds')
        walls, evs = hold_shard(f'cards {n}', ranks, want,
                                (height, bands, height // bands,
                                 WIDTH % 16 == 0 and (height // bands) % 8 == 0),
                                'nccl', failures, counts)
        wall_s, ev_s = per_sample(want)
        log(f'  ms per converge sample: {n} ranks wall {walls}, CUDA events '
            f'{evs}, busy {[r["busy_ms"] for r in ranks]}; single engine at '
            f'{bands} bands wall {wall_s:.1f}, CUDA events {ev_s:.1f}')

    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    pngs = {}
    for i, tag in enumerate(('spawned', 'one card each')):
        png = os.path.join(tmp, f'cards-{i}.png')
        state = os.path.join(tmp, f'cards-{i}.txt')
        with open(state, 'w') as f:
            f.write(OUTSIDE_STATE)
        args = [sys.executable, '-m', 'cuda_pathtracer_tpu_torch', '--shard',
                *OUTSIDE_ARGS, '--out', png, '--state', state]
        if tag == 'spawned':
            envs = [env]
        else:
            port = str(free_port())
            envs = [dict(env, RANK=str(r), LOCAL_RANK='0',
                         WORLD_SIZE=str(n), LOCAL_WORLD_SIZE='1',
                         MASTER_ADDR='127.0.0.1', MASTER_PORT=port,
                         CUDA_VISIBLE_DEVICES=str(r)) for r in range(n)]
        t = time.perf_counter()
        procs = [subprocess.Popen(args, cwd=tmp, env=e,
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE, text=True)
                 for e in envs]
        errs = []
        for proc in procs:
            try:
                errs.append(proc.communicate(timeout=600)[1])
            except subprocess.TimeoutExpired:
                proc.kill()
                errs.append(proc.communicate()[1])
        lines = [ln for ln in errs[0].splitlines()
                 if ln.startswith(('shard:', 'rendered', 'energy'))]
        codes = [proc.returncode for proc in procs]
        log(f'cards CLI {tag}: rc {codes}, {time.perf_counter() - t:.1f} s; '
            f'{lines}')
        if any(codes) or not any(f'shard: {n} ranks, backend nccl' in ln
                                 for ln in lines):
            failures.append(f'cards CLI {tag}: rc {codes}, not {n} ranks on '
                            f'NCCL: {errs[0][-1500:]}')
            continue
        with open(png, 'rb') as f:
            pngs[tag] = decode_png(f.read()).astype(int)
    if len(pngs) == 2:
        a, b = pngs.values()
        close = float((abs(a - b).max(axis=-1) <= 1).mean())
        log(f'cards CLI: the two PNGs equal {bool((a == b).all())}, '
            f'{close:.6f} of pixels within one level')
        if close < 0.99:
            failures.append(f'cards CLI: the PNGs agree on {close:.6f}')
    return counts


def native_route() -> str:
    """How the host builds BVHs: the native builder with OpenMP, without
    it, or numpy, with the flags."""
    from cuda_pathtracer_tpu_torch.accel import native
    flags = native.build_flags()
    if flags is None:
        return 'numpy (no native library)'
    kind = 'OpenMP' if '-fopenmp' in flags else 'serial, no OpenMP'
    return f'native, {kind}: {" ".join(flags)}'


def run_probes(launches: dict, results: dict, failures: list):
    """Phase 4: each probe module's own sweep through its kernel, with the
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


def agree_share(a, b) -> float:
    """Share of rows (pixels) of a and b within rtol 1e-3 + atol 1e-5."""
    import torch
    return float(torch.isclose(a, b, rtol=1e-3, atol=1e-5).all(
        dim=-1).float().mean())


def whitted_frame(rt, cam, clear: bool, label: str, failures: list) -> dict:
    """One Whitted frame of ``rt``, after a warm-up render of it: timed with
    CUDA events (the span on the device, idle gaps included) and the host
    clock, with its per-level lanes, then rendered again under the profiler
    for the device's busy time and the traversal launches' device ms.
    Checks the frame is finite and non-negative, and that no plain version
    ran on the card."""
    import torch
    from cuda_pathtracer_tpu_torch.ops import kernels
    from cuda_pathtracer_tpu_torch.utils import profiling
    rt.render(cam, should_clear=clear)
    stats = []
    before = dict(kernels.LAUNCHES)
    t = time.perf_counter()
    ms, _ = cuda_ms(lambda: rt.render(cam, should_clear=clear, stats=stats))
    wall = (time.perf_counter() - t) * 1e3
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.NAMES
                if kernels.LAUNCHES[k] != before[k]}
    frame = rt.frame.clone()
    shares = profiling.device_op_shares(
        lambda: rt.render(cam, should_clear=clear))
    busy = shares['_busy_ms']
    cats = {k: v for k, v in shares.items() if not k.startswith('_')}
    trav = [ms for name, ms in shares['_kernels'] if
            profiling.categorize_kernel(name).startswith('traverse')]
    active = sum(s['active'] for s in stats)
    shadow = sum(s['shadow'] for s in stats)
    trav_ms = sum(trav)
    log(f'whitted {label}: depth {len(stats)}, {ms:.2f} ms device (CUDA '
        f'events), {wall:.1f} ms host wall; {active} closest-hit + {shadow} '
        f'shadow rays, {(active + shadow) / ms / 1e3:.1f} Mrays/s over the '
        f'events\' span, {(active + shadow) / busy / 1e3:.1f} over busy '
        f'time; launches {launches}; profiled: busy {busy:.2f} ms, {len(trav)} '
        f'traversal launches {trav_ms:.3f} ms ({trav_ms / busy:.3f} of busy), '
        f'by category ' + ', '.join(f'{k} {v:.2f}' for k, v in
                                    sorted(cats.items(), key=lambda kv: -kv[1])))
    n_light = len(trav) // max(len([s for s in stats if s['active']]), 1) - 1
    for i, st in enumerate(stats):
        waves = trav[i * (1 + n_light):(i + 1) * (1 + n_light)]
        log(f'  level {i}: {st["lanes"]} lanes (JAX width), {st["active"]} '
            f'active, {st["dropped"]} dropped by the cap, {st["shadow"]} '
            f'shadow rays | traversal ms: closest '
            + ', shadow '.join(f'{m:.4f}' for m in waves))
    if tuple(frame.shape) != (rt.width * rt.height, 3) or not bool(
            torch.isfinite(frame).all()) or bool((frame < 0).any()):
        failures.append(f'whitted {label}: frame not finite and >= 0')
    if any(kernels.PLAIN_ON_CUDA.values()):
        failures.append(f'whitted {label}: plain versions on CUDA '
                        f'{kernels.PLAIN_ON_CUDA}')
    return dict(frame=frame, ms=ms, wall=wall, busy=busy, trav_ms=trav_ms,
                launches=launches, rays=active + shadow, stats=stats)


def hold_prepass(label: str, wave: str, scene, ro, rd, opt: dict,
                 failures: list) -> dict:
    """The prepass kernel on one recorded trace call (contiguous ro, rd and
    ``opt``: t_max, active, stop_on_hit, any_hit) against the plain prepass
    on the card: t, prim_type, prim_id, found, live and stop bit-identical.
    Returns the kernel's ms over 10 runs with CUDA events behind the sleep
    pre-roll, the plain version's ms, the bytes that bound the kernel
    (``PREPASS_*_BYTES``), the largest absolute difference from the plain
    version over every field (``err``; lanes whose bits agree count 0, a
    NaN against a number counts inf) and the lanes that differ in any
    field (``lanes``)."""
    import torch
    from cuda_pathtracer_tpu_torch.ops import traverse as tr
    ms, got = cuda_ms(lambda: tr.prepass(scene, ro, rd, **opt), reps=10,
                      warmup=1, preroll=True)
    pms, want = cuda_ms(lambda: tr.prepass_ref(scene, ro, rd, **opt))
    err, lanes, bad = 0.0, torch.zeros_like(want.found), []
    for f, a, b in zip(tr.Prepass._fields, got, want):
        same = (a.view(torch.int32) == b.view(torch.int32)
                if a.dtype == torch.float32 else a == b)
        gap = (a.double() - b.double()).abs().nan_to_num(nan=float('inf'))
        err = max(err, float(torch.where(same, 0.0, gap).max()))
        lanes |= ~same
        if not bool(same.all()):
            bad.append(f)
    n = ro.shape[0]
    n_bytes = n * (PREPASS_RAY_BYTES + PREPASS_OUT_BYTES + sum(
        x.element_size() for x in (opt['t_max'], opt['active'],
                                   opt['stop_on_hit']) if x is not None))
    b = bound(n_bytes, 0)[0]
    n_lanes = int(lanes.sum())
    log(f'  prepass on the level-0 {wave} wave of {label}: {n} rays, '
        f'{int(scene.sphere_pos.shape[0])} spheres, '
        f'{int(scene.plane_normal.shape[0])} planes, {int(want.found.sum())} '
        f'found | kernel {ms:.4f} ms, bound {b:.4f} ms (bytes, share '
        f'{b / ms:.3f}), plain {pms:.3f} ms; against plain: max abs err '
        f'{err}, {n_lanes} lanes differ, in {bad or "no field"}')
    if bad:
        failures.append(f'prepass {label} level-0 {wave}: kernel differs '
                        f'from plain in {bad} on {n_lanes} lanes (max abs '
                        f'err {err})')
    return dict(ms=ms, plain_ms=pms, bytes=n_bytes, err=err, lanes=n_lanes)


def time_epilogue(label: str, wave: str, scene, dyn, ro, rd, opt: dict,
                  want_uv: bool) -> dict:
    """The v2 walk on one recorded trace call, on the prepass kernel's t0,
    live and stop, timed alone (the seven arguments, as the benchmark's
    traverse roofline times it) and with the merge epilogue (as the
    renderer runs it), in turns, three times each over 10 runs behind the
    sleep pre-roll. Returns the least ms of each and their difference."""
    from cuda_pathtracer_tpu_torch.ops import traverse as tr
    from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as tp2
    pre = tr.prepass(scene, ro, rd, **opt)
    table = tp2.MergedTable(dyn.packet_merged, dyn.depth)
    uv = want_uv and not opt['any_hit']
    runs = dict(
        alone=lambda: tp2.traverse_merged(table, ro, rd, pre.t, pre.live,
                                          pre.stop, uv),
        merged=lambda: tp2.traverse_merged(table, ro, rd, pre.t, pre.live,
                                           pre.stop, uv, prepass=pre,
                                           active=opt['active']))
    got = {k: [] for k in runs}
    for _ in range(3):
        for k, fn in runs.items():
            got[k].append(cuda_ms(fn, reps=10, warmup=1, preroll=True)[0])
    out = {k: min(v) for k, v in got.items()}
    out['epilogue'] = out['merged'] - out['alone']
    log(f'  walk of the level-0 {wave} wave of {label}: alone '
        f'{out["alone"]:.4f} ms, with the merge epilogue {out["merged"]:.4f} '
        f'ms (least of 3 x 10 runs each, in turns): epilogue '
        f'{out["epilogue"]:+.4f} ms')
    return out


def hold_level0(rt, cam, label: str, failures: list) -> dict:
    """Renders one depth-7 frame of ``rt`` recording the rays of its level 0:
    the closest-hit wave of the primary rays (one per pixel, no jitter) and
    the first any-hit shadow wave (every ray from the light, with its t_max).
    Each wave is traced again through ``dispatch.trace`` on the route's
    kernels (the prepass kernel and the walk), and through it with the
    prepass and the walk swapped for their plain versions, on the card: t,
    prim_id, prim_type, intersected, u and v must be bit-identical; and the
    prepass kernel alone against the plain prepass (``hold_prepass``). On
    v2 the walk is also timed alone and with its merge epilogue
    (``time_epilogue``). Returns the prepass's sums over the two waves
    (kernel ms, plain ms, bytes, differing lanes), its largest error, and
    the walk's ms alone and merged, summed (0 on v1)."""
    import torch
    from cuda_pathtracer_tpu_torch.models import raytracer as rt_mod
    from cuda_pathtracer_tpu_torch.ops import dispatch as dispatch_mod
    from cuda_pathtracer_tpu_torch.ops import traverse as tr
    from cuda_pathtracer_tpu_torch.ops import traverse_packet as tp1
    from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as tp2
    calls = []

    def pick(args, kw):
        calls.append(args[2].shape[0])
        return ('closest', 'shadow')[len(calls) - 1] if len(calls) <= 2 else None

    with Recorder(rt_mod, 'trace', pick=pick) as rec:
        rt.render(cam, should_clear=False)
    stats = {}

    def merged_ref(table, ro, rd, t0, live, stop, want_uv=False,
                   prepass=None, active=None):
        out = tp2.traverse_merged_ref(table, ro, rd, t0, live, stop, want_uv,
                                      stats=stats)
        return out if prepass is None else tr.merge_hit(*out, prepass, active)

    def split_ref(tables, ro, rd, t0, live, stop, cheap=False):
        return tp1.traverse_packet_ref(tables, ro, rd, t0, live, stop, cheap,
                                       stats=stats)

    pre = dict(ms=0.0, plain_ms=0.0, bytes=0.0, lanes=0, err=0.0, alone=0.0,
               merged=0.0)
    for wave in ('closest', 'shadow'):
        if wave not in rec.saved:
            failures.append(f'whitted {label}: no level-0 {wave} wave recorded')
            continue
        args, kw = rec.saved[wave]
        ms, k = cuda_ms(lambda: dispatch_mod.trace(*args, **kw))
        stats.clear()
        with patched(dispatch_mod, 'traverse_merged', merged_ref), \
                patched(dispatch_mod, 'prepass', tr.prepass_ref), \
                patched(tp1, 'prepass', tr.prepass_ref), \
                patched(tp1, 'traverse_split', split_ref):
            pms, p = cuda_ms(lambda: dispatch_mod.trace(*args, **kw))
        active = kw.get('active')
        n_live = int(active.sum()) if active is not None else args[2].shape[0]

        def bits(hit, f):
            x = getattr(hit, f)
            return x.view(torch.int32) if x.dtype == torch.float32 else x
        diff = {f: int((bits(k, f) != bits(p, f)).sum())
                for f in k._fields if getattr(k, f) is not None}
        if (k.u is None) != (p.u is None):
            diff['u'] = -1
        visits = stats.get('inner', 0) + stats.get('leaf', 0)
        log(f'  level-0 {wave} wave of {label}: {args[2].shape[0]} rays, '
            f'{n_live} live, {int(k.intersected.sum())} hits, '
            f'{visits / max(n_live, 1):.2f} visits per live ray (plain walk); '
            f'trace {ms:.3f} ms, plain {pms:.1f} ms; mismatches vs plain {diff}')
        if any(diff.values()):
            failures.append(f'whitted {label} level-0 {wave}: kernel disagrees '
                            f'with plain {diff}')
        # the rays as dispatch.trace hands them to the kernels: contiguous
        scene, dyn, ro, rd = args
        ro, rd = ro.contiguous(), rd.contiguous()
        opt = {key: kw[key].contiguous() if kw.get(key) is not None else None
               for key in ('t_max', 'active', 'stop_on_hit')}
        opt['any_hit'] = kw.get('any_hit', False)
        h = hold_prepass(label, wave, scene, ro, rd, opt, failures)
        for key in ('ms', 'plain_ms', 'bytes', 'lanes'):
            pre[key] += h[key]
        pre['err'] = max(pre['err'], h['err'])
        if dispatch_mod.use_packet2(dyn):
            e = time_epilogue(label, wave, scene, dyn, ro, rd, opt,
                              kw.get('want_uv', False))
            pre['alone'] += e['alone']
            pre['merged'] += e['merged']
    return pre


def hold_shading(rt, cam, label: str, failures: list) -> dict:
    """Renders one depth-7 frame of ``rt`` recording every level's rays and
    weights, then shades each level again on the card through the two
    ``whitted_shade`` kernels and through the plain route
    (``raytracer._level_plain``) on the same rays, closest hits and shadow
    hits, each lane its own pixel: the shadow rays handed to every any-hit
    trace (origin, direction, t_max, active), each lane's contribution, the
    children (origin, direction, weight, pixel, active) and the count of
    shadow rays must be bit-equal. Each kernel is timed over 10 calls with
    CUDA events behind the sleep pre-roll, and so is the plain route's
    shading over 3 (its traces replayed from the record, so no traversal is
    timed; its sky copy waits for the pre-roll, so its time holds the
    host's issue after that). Returns the frame's sums: kernel ms, plain
    ms, bytes (``SHADE_*_BYTES``) and the largest difference."""
    import torch
    from cuda_pathtracer_tpu_torch.models import raytracer as rt_mod
    from cuda_pathtracer_tpu_torch.ops import whitted_shade as ws
    levels = []
    orig = rt_mod._shade_level_kernels

    def spy(tables, scene, dyn, ro, rd, weight, *rest):
        levels.append((ro.clone(), rd.clone(), weight.clone()))
        return orig(tables, scene, dyn, ro, rd, weight, *rest)
    with patched(rt_mod, '_shade_level_kernels', spy):
        rt.render(cam, should_clear=False)
    scene, dyn = rt.arrays, rt.dyn
    tab = ws.tables(scene, dyn)
    L = tab.n_lights
    real_trace = rt_mod.trace
    total = dict(ms=0.0, plain_ms=0.0, bytes=0.0, err=0.0)

    def same(a, b):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.shape == b.shape and torch.equal(a, b)

    def err(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0
    for depth, (ro, rd, w) in enumerate(levels):
        n = ro.shape[0]
        pixel = torch.arange(n, device=ro.device)
        calls = []

        def traced(*a, **kw):
            hit = real_trace(*a, **kw)
            calls.append((a[2], a[3], kw.get('t_max'), kw.get('active'), hit))
            return hit
        p_out = torch.zeros((n, 3), device=ro.device)
        p_count = torch.zeros((), dtype=torch.int64, device=ro.device)
        with patched(rt_mod, 'trace', traced):
            p_children = rt_mod._level_plain(scene, dyn, ro, rd, w, pixel,
                                             p_out, p_count)
        lv = ws.level(ro, rd, calls[0][4])
        sro, sfl, tmax, sact = ws.shade_pre(tab, lv)
        occluded = (torch.stack([c[4].intersected for c in calls[1:]])
                    if L else sact)
        k_out = torch.zeros_like(p_out)
        k_count = torch.zeros_like(p_count)
        k_children = ws.shade_post(tab, lv, w, pixel, occluded, k_out,
                                   k_count)
        torch.cuda.synchronize()
        diff = [f'light {li} shadow {f}' for li, c in enumerate(calls[1:])
                for f, x, y in zip(('origin', 'direction', 't_max', 'active'),
                                   c[:4], (sro[li], sfl[li], tmax[li],
                                           sact[li])) if not same(x, y)]
        diff += [f'child {f}' for f, x, y in zip(
            ('origin', 'direction', 'weight', 'pixel', 'active'), p_children,
            k_children) if not same(x, y)]
        if not same(p_out, k_out):
            diff.append('contribution')
        if int(p_count) != int(k_count) or len(calls) != 1 + L:
            diff.append(f'shadow rays {int(p_count)} vs {int(k_count)}, '
                        f'{len(calls)} traces')
        e = max([err(p_out, k_out)] + [err(x, y) for x, y in zip(
            p_children[:3], k_children[:3])])

        t_out, t_count = torch.zeros_like(p_out), torch.zeros_like(p_count)
        pre_ms, _ = cuda_ms(lambda: ws.shade_pre(tab, lv), reps=10,
                            preroll=True)
        post_ms, _ = cuda_ms(lambda: ws.shade_post(
            tab, lv, w, pixel, occluded, t_out, t_count), reps=10,
            preroll=True)
        replay = []

        def replayed(*a, **kw):
            return replay.pop(0)

        def plain():
            replay[:] = [c[4] for c in calls]
            return rt_mod._level_plain(scene, dyn, ro, rd, w, pixel, t_out,
                                       t_count)
        with patched(rt_mod, 'trace', replayed):
            plain_ms, _ = cuda_ms(plain, reps=3, preroll=True)
        pre_b = n * (SHADE_PRE_BYTES + L * SHADE_PRE_LIGHT_BYTES)
        post_b = n * (SHADE_POST_BYTES + L * SHADE_POST_LIGHT_BYTES)
        log(f'  shading level {depth} of {label}: {n} lanes, {L} lights, '
            f'{int(k_count)} shadow rays | shade_pre {pre_ms:.4f} ms (bound '
            f'{bound(pre_b, 0)[0]:.4f}), shade_post {post_ms:.4f} ms (bound '
            f'{bound(post_b, 0)[0]:.4f}), plain {plain_ms:.3f} ms; '
            f'differ from plain: {diff or "nothing"}')
        if diff:
            failures.append(f'whitted {label} shading level {depth}: kernels '
                            f'differ from the plain route: {diff}')
        total['ms'] += pre_ms + post_ms
        total['plain_ms'] += plain_ms
        total['bytes'] += pre_b + post_b
        total['err'] = max(total['err'], e)
    if not levels:
        failures.append(f'whitted {label}: no level shaded')
        return total
    b = bound(total['bytes'], 0)[0]
    log(f'  shading of {label}, {len(levels)} levels: kernels '
        f'{total["ms"]:.4f} ms, bound {b:.4f} ms (share {b / total["ms"]:.3f})'
        f', plain {total["plain_ms"]:.3f} ms')
    return total


def run_whitted(cli_main, sibenik, tmp: str, failures: list) -> dict:
    """Phase 3a: the Whitted raytracer at 1920x1080. Sibenik (v2): a clearing
    frame (depth 2) and a converged one (depth 7). The CLI's ``--mode ray``
    on outside at t = 5 (one depth-2 frame after the refit) with
    ``PACKET_V1`` on and then off, then one depth-7 outside frame on each
    route; each depth-7 frame's levels are shaded again by the
    ``whitted_shade`` kernels and by the plain route (``hold_shading``);
    v1 and v2 must agree, and so must a 64x48 depth-7 outside frame on the
    card and on the CPU; on every route the prepass kernel launches once per
    walk. Returns ({route: launches}, sibenik's shading totals from
    ``hold_shading``, sibenik's prepass totals from ``hold_level0``)."""
    import torch
    from cuda_pathtracer_tpu_torch.core.camera import Camera
    from cuda_pathtracer_tpu_torch.models import raytracer as rt_mod
    from cuda_pathtracer_tpu_torch.ops import dispatch as dispatch_mod
    from cuda_pathtracer_tpu_torch.ops import kernels
    from cuda_pathtracer_tpu_torch.scene import builder
    routes = {'v1': 'traverse_packet', 'v2': 'traverse'}
    counts = {}

    kernels.reset_counts()
    rt = rt_mod.Raytracer(sibenik, WIDTH, HEIGHT, device='cuda')
    cam = Camera.create(*SIBENIK_CAMERA, device='cuda')
    for clear in (True, False):
        f = whitted_frame(rt, cam, clear, f'sibenik v2 depth '
                          f'{2 if clear else 7}', failures)
    counts['sibenik'] = dict(kernels.LAUNCHES)
    if kernels.LAUNCHES['traverse'] <= 0 or kernels.LAUNCHES[
            'traverse_packet'] or kernels.LAUNCHES['whitted_shade'] <= 0 \
            or kernels.LAUNCHES['prepass'] != kernels.LAUNCHES['traverse']:
        failures.append(f'whitted sibenik: launches {kernels.LAUNCHES}')
    prepass = hold_level0(rt, cam, 'sibenik v2 depth 7', failures)
    shading = hold_shading(rt, cam, 'sibenik v2 depth 7', failures)
    del rt

    frames = {}
    for v1 in (True, False):
        tag = 'v1' if v1 else 'v2'
        args = ['--scene', 'outside', '--mode', 'ray', '--width', str(WIDTH),
                '--height', str(HEIGHT), '--time', '5', '--device', 'cuda',
                '--out', os.path.join(tmp, f'ray-{tag}.png'), '--state',
                os.path.join(tmp, f'ray-{tag}.txt')]
        kernels.reset_counts()
        t = time.perf_counter()
        dispatch_mod.PACKET_V1 = v1
        err = io.StringIO()
        try:
            with Recorder(rt_mod, 'Raytracer', returns=True) as app, \
                    contextlib.redirect_stderr(err):
                rc = cli_main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = dict(kernels.LAUNCHES)
            text = err.getvalue()
            log(f'cli --mode ray outside {tag}: rc={rc}, {wall:.2f} s wall, '
                f'launches {got}; ' + ' | '.join(
                    line for line in text.splitlines()
                    if line.startswith('rendered')))
            if rc != 0 or re.search(r'^energy', text, re.M):
                failures.append(f'cli --mode ray {tag}: rc={rc}')
                continue
            rt = app.returned[0]
            if got[routes[tag]] <= 0 or got[routes['v2' if v1 else 'v1']] \
                    or got['whitted_shade'] <= 0 \
                    or got['prepass'] != got[routes[tag]]:
                failures.append(f'cli --mode ray {tag}: launches {got}')
            if any(kernels.PLAIN_ON_CUDA.values()):
                failures.append(f'cli --mode ray {tag}: plain versions on '
                                f'CUDA {kernels.PLAIN_ON_CUDA}')
            if rt.scene.refits < 1:
                failures.append(f'cli --mode ray {tag}: no refit')
            frames[(tag, 2)] = rt.frame.clone()
            # the same scene and engine, one converged (depth 7) frame
            out_cam = Camera.create([0.0, 2.0, -3.0], [0.0, 0.0, 1.0], 1.5,
                                    5.0, 0.01, device='cuda')
            kernels.reset_counts()
            f = whitted_frame(rt, out_cam, False, f'outside {tag} depth 7',
                              failures)
            counts[f'outside-{tag}'] = dict(kernels.LAUNCHES)
            frames[(tag, 7)] = f['frame']
            hold_level0(rt, out_cam, f'outside {tag} depth 7', failures)
            hold_shading(rt, out_cam, f'outside {tag} depth 7', failures)
            del rt, app
        finally:
            dispatch_mod.PACKET_V1 = False
    for depth in (2, 7):
        if ('v1', depth) in frames and ('v2', depth) in frames:
            share = agree_share(frames[('v1', depth)], frames[('v2', depth)])
            log(f'whitted outside depth {depth}: v1 vs v2 {share:.6f} of '
                f'pixels agree (rtol 1e-3, atol 1e-5)')
            if share < 0.995:
                failures.append(f'whitted outside depth {depth}: v1 vs v2 '
                                f'only {share:.6f}')

    small = {}
    for dev in ('cuda', 'cpu'):
        scene = builder.get_scene('outside')
        scene.update(None, 5.0)
        srt = rt_mod.Raytracer(scene, 64, 48, device=dev)
        scam = Camera.create([0.0, 2.0, -3.0], [0.0, 0.0, 1.0], 1.5, 5.0,
                             0.01, device=dev)
        srt.render(scam, should_clear=True)
        srt.render(scam, should_clear=False)
        small[dev] = srt.frame.cpu()
    share = agree_share(small['cuda'], small['cpu'])
    log(f'whitted outside 64x48 depth 7: card vs CPU {share:.6f} of pixels '
        f'agree')
    if share < 0.995:
        failures.append(f'whitted 64x48: card vs CPU only {share:.6f}')
    return counts, shading, prepass


def _poke(port: int, stop, seen: dict):
    """While the serve loop runs: send the key ``w`` as soon as the viewer
    answers, then fetch ``/frame.png`` until one frame has come, and stop
    (so that the loop's later frames share the interpreter with no HTTP
    traffic)."""
    base = f'http://127.0.0.1:{port}'
    while not stop.is_set():
        try:
            if 'key' not in seen:
                urllib.request.urlopen(f'{base}/key?k=w', timeout=5).read()
                seen['key'] = time.perf_counter()
            png = urllib.request.urlopen(f'{base}/frame.png', timeout=5).read()
            seen['fetches'] = seen.get('fetches', 0) + 1
            if png:
                seen['png'] = png
                seen['done'] = time.time()
                return
        except OSError:
            pass
        stop.wait(0.05)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_loops(cli_main, tmp: str, failures: list) -> dict:
    """Phase 3b: ``--serve <a free port> --frames 30`` on outside at 640x480,
    in path mode and then ray mode, with a thread that sends the key ``w``
    and fetches the frames. The loop's time is split by the program's spans
    (``utils/profiling.record`` with ``fence``, so each span waits for the
    device work it launched: ``serve.render``, ``serve.update``,
    ``serve.finish``, ``film.display``, ``film.to_host``, ``serve.present``,
    and the Whitted frame's own). Returns {mode: frames per second}."""
    import torch
    from cuda_pathtracer_tpu_torch.ops import kernels
    from cuda_pathtracer_tpu_torch.utils import display, profiling
    fps = {}
    for mode in ('path', 'ray'):
        port = free_port()
        state = os.path.join(tmp, f'loop-{mode}.txt')
        with open(state, 'w') as f:
            f.write(OUTSIDE_STATE)
        args = ['--scene', 'outside', '--mode', mode, '--width',
                str(LOOP_WIDTH), '--height', str(LOOP_HEIGHT), '--serve',
                str(port), '--frames', str(LOOP_FRAMES), '--state', state,
                '--device', 'cuda']
        stop, seen = threading.Event(), {}
        poker = threading.Thread(target=_poke, args=(port, stop, seen),
                                 daemon=True)
        kernels.reset_counts()
        err = io.StringIO()
        t = time.perf_counter()
        poker.start()
        try:
            with contextlib.ExitStack() as es:
                es.enter_context(contextlib.redirect_stderr(err))
                stages = es.enter_context(profiling.record(fence=True))
                rc = cli_main(args)
            torch.cuda.synchronize()
        finally:
            stop.set()
            poker.join(timeout=10)
        wall = time.perf_counter() - t
        text = err.getvalue()
        # when each frame had been handed to the viewer (time.time())
        shown = [sp.end_ns / 1e9 for sp in stages
                 if sp.name == 'serve.present']
        emas = re.findall(r'^running average fps: (\S+)$', text, re.M)
        rate = ((len(shown) - 1) / (shown[-1] - shown[0])
                if len(shown) > 1 else 0.0)
        # the frames presented after the fetching thread had stopped
        quiet = [s for s in shown if s > seen.get('done', float('inf'))]
        quiet_rate = ((len(quiet) - 1) / (quiet[-1] - quiet[0])
                      if len(quiet) > 1 else 0.0)
        fps[mode] = quiet_rate
        png = seen.get('png', b'')
        size = struct.unpack('>II', png[16:24]) if len(png) >= 24 else None
        # the key moved the eye: the view line is renormalised on every
        # frame, key or not, so only the eye tells
        with open(state) as f:
            eye = [float(x) for x in f.readline().split('|')]
        moved = 'key' in seen and eye != OUTSIDE_EYE
        log(f'serve loop {mode} {LOOP_WIDTH}x{LOOP_HEIGHT}: rc={rc}, '
            f'{len(shown)} frames, {rate:.2f} frames/s between the first and '
            f'the last frame, {quiet_rate:.2f} over the {len(quiet)} frames '
            f'after the fetching thread stopped ({wall:.1f} s wall with the '
            f'scene build); fps EMA lines {emas}; {seen.get("fetches", 0)} '
            f'fetches, PNG IHDR {size}; key sent {"key" in seen}, saved eye '
            f'{eye} (was {OUTSIDE_EYE}), camera moved {moved}; launches '
            f'{ {k: v for k, v in kernels.LAUNCHES.items() if v} }')
        for line in text.splitlines():
            if line.startswith(('Total energy', 'energy audit')):
                log('  ' + line)
        for line in profiling.span_totals(stages).splitlines():
            log('  ' + line)
        if poker.is_alive():
            failures.append(f'serve {mode}: the fetching thread did not stop')
        if rc != 0 or len(shown) != LOOP_FRAMES or not emas:
            failures.append(f'serve {mode}: rc={rc}, {len(shown)} frames, fps '
                            f'lines {emas}')
        if size != (LOOP_WIDTH, LOOP_HEIGHT) or not png.startswith(
                b'\x89PNG') or not moved:
            failures.append(f'serve {mode}: PNG IHDR {size}, camera moved '
                            f'{moved}')
        if kernels.LAUNCHES['traverse'] <= 0 or (
                mode == 'path' and kernels.LAUNCHES['blur'] <= 0):
            failures.append(f'serve {mode}: launches {kernels.LAUNCHES}')
        if any(kernels.PLAIN_ON_CUDA.values()):
            failures.append(f'serve {mode}: plain versions on CUDA '
                            f'{kernels.PLAIN_ON_CUDA}')
    return fps


def run_checkpoint(cli_main, tmp: str, failures: list):
    """Phase 3c: checkpoint and resume of outside at 1920x1080 (t = 5).
    Through the CLI: ``--spp 6 --checkpoint``, then ``--resume --spp 7
    --checkpoint``, beside a straight ``--spp 7 --checkpoint``. On resume the
    CLI skips the clearing frame and so, as the JAX CLI does, traces the 7th
    sample on the scene as built rather than as animated to ``--time``
    (ROADMAP C.6): the resumed checkpoint is held against the same steps in
    this process (an engine built on the scene as built, the scene animated
    to t = 5, the 6-sample checkpoint loaded, one sample), and the straight
    run's counters and pixels are printed beside it, not held. Then the
    engines' own round trip: an engine at 6 samples saves, a second engine
    built on the same animated scene loads, and both render a 7th sample.
    Each pair must agree on (sample_idx, rand_idx) and on at least 99% of
    the pixels (rtol 1e-3, atol 1e-5; the guiding scatter's atomics reorder
    the sums)."""
    import numpy as np
    import torch
    from cuda_pathtracer_tpu_torch.core.camera import Camera
    from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu_torch.scene import builder
    from cuda_pathtracer_tpu_torch.utils import checkpoint as ck
    base = ['--scene', 'outside', '--width', str(WIDTH), '--height',
            str(HEIGHT), '--time', '5', '--device', 'cuda', '--out',
            os.path.join(tmp, 'ck.png'), '--state', os.path.join(tmp, 'ck.txt')]
    paths = {k: os.path.join(tmp, f'{k}.npz')
             for k in ('c6', 'c7r', 'c7', 'c7x', 'e7', 'e7r')}
    for extra in (['--spp', '6', '--checkpoint', paths['c6']],
                  ['--spp', '7', '--resume', paths['c6'], '--checkpoint',
                   paths['c7r']],
                  ['--spp', '7', '--checkpoint', paths['c7']]):
        err = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli_main(base + extra)
        log(f'cli {" ".join(extra[:4])}: rc={rc}, '
            f'{time.perf_counter() - t:.2f} s | ' + ' | '.join(
                line for line in err.getvalue().splitlines()
                if line.startswith(('rendered', 'resumed', 'checkpoint'))))
        if rc != 0:
            failures.append(f'checkpoint cli {extra}: rc={rc}')
            return

    def held(label, a, b, hold=True):
        with np.load(paths[a]) as x, np.load(paths[b]) as y:
            counts = [(int(z['sample_idx']), int(z['rand_idx'])) for z in (x, y)]
            finite = all(bool(np.isfinite(z[k]).all()) for z in (x, y)
                         for k in ('lum', 'alb'))
            share = agree_share(torch.from_numpy(x['lum'][:, :3]),
                                torch.from_numpy(y['lum'][:, :3]))
        log(f'{label}: (sample_idx, rand_idx) {counts[0]} vs {counts[1]}, '
            f'{share:.6f} of pixels agree, finite {finite}'
            + ('' if hold else ' (not held: ROADMAP C.6)'))
        if not finite or counts[0][0] != 7 or (
                hold and (counts[0] != counts[1] or share < 0.99)):
            failures.append(f'checkpoint {label}: {counts}, {share:.6f} of '
                            f'pixels agree, finite {finite}')

    # the CLI's resume, step by step in this process
    scene = builder.get_scene('outside')
    pt = Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    scene.update(None, 5.0)
    cam = ck.load_checkpoint(paths['c6'], pt)
    pt.render(cam, 5.0, 0.0, should_clear=False)
    ck.save_checkpoint(paths['c7x'], pt, cam)
    del pt
    held('cli resumed vs its steps in process', 'c7r', 'c7x')
    held('cli resumed vs straight', 'c7r', 'c7', hold=False)

    # the engines' round trip on the animated scene
    cam = Camera.create([0.0, 2.0, -3.0], [0.0, 0.0, 1.0], 1.5, 5.0, 0.01,
                        device='cuda')
    pt = Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    pt.render(cam, should_clear=True)
    while pt.sample_idx < 6:
        pt.render(cam)
    path = os.path.join(tmp, 'engine6.npz')
    ck.save_checkpoint(path, pt, cam)
    pt2 = Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    cam2 = ck.load_checkpoint(path, pt2)
    pt.render(cam)
    pt2.render(cam2)
    ck.save_checkpoint(paths['e7'], pt, cam)
    ck.save_checkpoint(paths['e7r'], pt2, cam2)
    held(f'engine resumed vs uninterrupted at {WIDTH}x{HEIGHT}', 'e7r', 'e7')
    del pt, pt2
    torch.cuda.empty_cache()


def main() -> int:
    import argparse
    import torch
    p = argparse.ArgumentParser(description='smoke run of the port on the card')
    p.add_argument('--cards', type=int, default=0,
                   help='only --shard across this many cards (NCCL)')
    cards = p.parse_args().cards
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
    log(f'native BVH builder: {native_route()} (build '
        f'{time.perf_counter() - t:.2f} s)')
    if not ok or '-fopenmp' not in native.build_flags():
        for line in native.build_log().splitlines()[-8:]:
            log('  g++: ' + line)
    if not ok:
        failures.append('native BVH builder: not built; the host builds '
                        'BVHs with numpy')
    if cards:
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            counts = run_cards(cards, tmp, failures)
            log(f'--cards {cards}: {time.perf_counter() - t:.1f} s wall; '
                f'launches per rank {counts}')
        return finish(failures, card, None, None)

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
    cam = Camera.create(*SIBENIK_CAMERA, device='cuda')

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

    sib_waves = {}
    for wave in ('primary', 'shadow', 'bounce-1', 'tail-1'):
        if wave not in trav.saved:
            failures.append(f'traverse: no {wave} wave captured')
            continue
        (table, ro, rd, t0, live, stop), kw = trav.saved[wave]
        any_hit = bool(stop.all())
        dead = torch.zeros_like(live)
        h = sib_waves[wave] = hold_merged('traverse', wave, trav.saved[wave],
                                          failures)
        t, gid, found = h['out']
        hits = h['hits']
        n_live = h['n_live']
        a = acc['traverse']
        a['ms'] += h['ms']
        a['plain_ms'] += h['plain_ms']
        a['err'] = max(a['err'], h['err'])
        a['bytes'] += h['bytes']
        a['ops'] += h['ops']

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
    del pt          # the scene serves the Whitted phase
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

    # ---- phase 3: the Whitted raytracer, the real-time loops, checkpoints
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        whitted, shading, pre = run_whitted(cli_main, scene, tmp, failures)
        launches['whitted_shade'] = whitted['sibenik']['whitted_shade']
        results['whitted_shade'] = dict(
            max_abs_err=shading['err'], ms=shading['ms'],
            plain_ms=shading['plain_ms'], library_ms=None)
        results['whitted_shade']['bound_ms'], \
            results['whitted_shade']['bound_by'] = bound(shading['bytes'], 0)
        # the prepass on sibenik's level-0 closest-hit and shadow waves
        launches['prepass'] = whitted['sibenik']['prepass']
        results['prepass'] = dict(max_abs_err=pre['err'], ms=pre['ms'],
                                  plain_ms=pre['plain_ms'], library_ms=None)
        results['prepass']['bound_ms'], results['prepass']['bound_by'] = \
            bound(pre['bytes'], 0)
        log(f'sibenik level-0 waves: prepass max abs err {pre["err"]}, '
            f'{pre["lanes"]} lanes differ; walk alone {pre["alone"]:.4f} ms, '
            f'with the merge epilogue {pre["merged"]:.4f} ms (epilogue '
            f'{pre["merged"] - pre["alone"]:+.4f} ms)')
        del scene
        torch.cuda.empty_cache()
        log(f'phase 3a (Whitted frames): {time.perf_counter() - t:.1f} s '
            f'wall; launches per run {whitted}')
        t = time.perf_counter()
        fps = run_loops(cli_main, tmp, failures)
        log(f'phase 3b (serve loops): {time.perf_counter() - t:.1f} s wall; '
            f'frames/s {fps} on {card}')
        t = time.perf_counter()
        run_checkpoint(cli_main, tmp, failures)
        log(f'phase 3c (checkpoint and resume): {time.perf_counter() - t:.1f} '
            f's wall')

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

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        scenes = run_scenes(cli_main, sib_waves, tmp, failures)
        log(f'phase 5 (minecraft, 2mtris, .chai): '
            f'{time.perf_counter() - t:.1f} s wall; launches per run {scenes}')

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        shard = run_shard(tmp, failures)
        log(f'phase 6 (--shard, JPEG): {time.perf_counter() - t:.1f} s wall; '
            f'launches per run {shard}')

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), 'tests'))
        imgs = run_images(card, tmp, failures)
        log(f'phase 7 (images): {time.perf_counter() - t:.1f} s wall; '
            f'launches per run {imgs}')

    run_probes(launches, results, failures)

    loaded = sorted(m for m in sys.modules
                    if (m in ('jax', 'cuda_pathtracer_tpu')
                        or m.startswith(('jax.', 'cuda_pathtracer_tpu.')))
                    and sys.modules[m] is not None)
    if loaded:
        failures.append(f'modules of JAX or the JAX package were imported: '
                        f'{loaded}')
    return finish(failures, card, launches, results)


def finish(failures: list, card: str, launches, results) -> int:
    """Print the failures and return 1, or print the kernels' line (when
    ``launches``), the card line and the result line and return 0."""
    import torch
    if failures:
        for f in failures:
            print('FAIL: ' + f, file=sys.stderr)
        return 1
    if launches is not None:
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
