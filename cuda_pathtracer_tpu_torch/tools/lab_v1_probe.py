"""The v1 packet walk and its ablations on real sibenik waves: the Hopper
counterpart of the Pallas lab ``tools/kernel_lab.py:256`` (``run_variant``
:247, ``variant_kernel`` :40, a copy of the v1 kernel with hooks; its waves
at :273-326).

    python -m cuda_pathtracer_tpu_torch.tools.lab_v1_probe [--device cpu]

The lab computes a PACKET walk: a program's packets of 128 rays each
descend together, every decision a minimum over all the packet's live rays
(the nearest-first pick over 16 slots), with a (row, visited-mask) stack per
packet. That is not the port's v1 kernel (``csrc/traverse_packet.cu``, one
ray per 16-lane group, another visit order). Here one block of 128 threads
walks a program's 2 packets, one thread per lane: a leaf visit is lane-local
Moller-Trumbore; an inner visit slab-tests the 16 slots per lane, reduces
them across the block (warp reductions and a shared-memory combine, one
barrier), and thread 0 writes the decision words to shared memory, where
every thread reads them after a second barrier; the stack is in shared
memory. The hooks price on Hopper what they priced on the TPU:
  v0      the walk as the lab ships it (three decision words)
  script  the decision ignored: the next row is cur + 1 up to row 2000
  nodec   no reductions at all (inner rows only, cur + 1 up to 2000)
  packed  one decision word instead of three
  phase   both packets' vector work before both decisions (one pair of
          barriers for the two)
The waves: sibenik's primary wave of 1920 x 192 rows of a 1080-high frame
in 8 x 16 tiles (the lab's camera), and a bounce wave from its hits,
hemisphere directions sorted by Morton code and octant. Each variant is
timed beside the port's ``traverse_split`` (v1, 16-lane groups) and
``traverse_merged`` (v2) on the same rays.

:func:`walk` launches ``csrc/probe_packet_walk.cu`` on CUDA tensors (or
raises) and takes the plain version :func:`walk_ref` for CPU tensors. The
outputs are the lab's (t, gid bits, found, 0 per packet), the stacks and
decision words each program leaves, a per-packet digest (the decision
words written and every next row) and a per-lane digest (each inner
visit's 16-bit hit mask), since ``script`` and ``nodec`` return t0, -1, 0.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from ..core import camera as cam_mod
from ..ops import intersect as isect
from ..ops import kernels
from ..ops import traverse_packet as tp1
from ..ops import traverse_packet2 as tp2
from . import packet_ops as po
from . import timing

NAME = 'probe_packet_walk'
VARIANTS = ('v0', 'script', 'nodec', 'packed', 'phase')
WAVES = ('prim', 'bounce')
NPK = 2
PACKET = 128
RAY_ROWS = 16          # ox oy oz dx dy dz ivx ivy ivz t0 live soh oivx oivy oivz pad
DONE = 2 ** 30
SCRIPT_END = 2000      # kernel_lab.py:165,168
MAX_STACK = 64         # the kernel's stack entries per packet
CAMERA = dict(eye=[0.0, 5.0, -16.0], view_dir=[0.0, 0.0, 1.0], d=1.5,
              focal_length=12.0, aperture=0.0)
OUTPUTS = ('out', 'stk_n', 'stk_m', 'dec_s', 'digest', 'lane_digest')
# FP32 operations per visit and lane, as the plain walk does them
INNER_OPS = 16 * 27
LEAF_OPS = 12 * 62


# ---------------------------------------------------------------- waves ----

def ray_blocks(ro, rd):
    """``kernel_lab.py:288-297``: rays [B, 3] -> ray blocks f32[B / 128 *
    16, 128], one block of RAY_ROWS rows per packet (t0 = 1.5e38, every ray
    live, none stop on a hit)."""
    b = ro.shape[0]
    inv = isect.safe_inv_dir(rd)
    one = torch.ones((b, 1), dtype=torch.float32, device=ro.device)
    zero = torch.zeros_like(one)
    m = torch.cat([ro, rd, inv, one * 1.5e38, one, zero, ro * inv, zero], 1)
    return m.view(-1, PACKET, RAY_ROWS).transpose(1, 2).reshape(-1, PACKET)


def tile_order(width: int, rows: int, device=None):
    """``kernel_lab.py:284-286``: the 8 x 16 tile permutation of a wave."""
    return torch.arange(width * rows, device=device).view(
        rows // 8, 8, width // 16, 16).permute(0, 2, 1, 3).reshape(-1)


def primary_wave(cam, width: int, rows: int, frame_h: int, y0: int = 0):
    """``kernel_lab.py:277-281``: pinhole rays of ``rows`` rows from ``y0``
    of a ``frame_h``-high frame, in pixel order: (ro, rd)."""
    dev = cam.eye.device
    ys, xs = torch.meshgrid(torch.arange(y0, y0 + rows, device=dev),
                            torch.arange(width, device=dev), indexing='ij')
    return cam_mod.generate_rays_simple(cam, xs.reshape(-1), ys.reshape(-1),
                                        width, frame_h)


def bounce_wave(ro, rd, hit_t, seed: int = 1):
    """``kernel_lab.py:304-326`` in numpy: from each primary hit (t capped
    at 100) a direction from a normal draw, flipped into the hemisphere
    facing back along the ray, the rays sorted by a 30-bit Morton code of
    the hit point and the direction's octant. Returns (ro, rd) f32[B, 3]."""
    ron, rdn = np.asarray(ro, np.float32), np.asarray(rd, np.float32)
    hitn = np.asarray(hit_t, np.float32)
    b = ron.shape[0]
    hp = (ron + rdn * (np.minimum(hitn, 100.0)[:, None] - 1e-3)).astype(
        np.float32)
    rng = np.random.default_rng(seed)
    d2 = rng.normal(size=(b, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    flip = (d2 * rdn).sum(1) > 0
    d2[flip] = -d2[flip]
    q = ((hp - hp.min(0)) / (np.ptp(hp, 0) + 1e-6) * 1023).astype(np.int64)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    octant = ((d2[:, 0] > 0).astype(np.int64)
              | ((d2[:, 1] > 0).astype(np.int64) << 1)
              | ((d2[:, 2] > 0).astype(np.int64) << 2))
    om = np.argsort((morton << 3) | octant, kind='stable')
    return hp[om], d2[om]


def waves(scene_arrays, tables, cam, width: int, rows: int, frame_h: int,
          y0: int = 0):
    """The lab's two waves on the port's scene: {name: (ro, rd)} in walk
    order (tile order; Morton and octant order), on the camera's device.
    The primary hits that seed the bounce come from the port's v1 trace
    (prepass, then ``traverse_split``), as the lab takes them from the v1
    kernel."""
    ro, rd = primary_wave(cam, width, rows, frame_h, y0)
    perm = tile_order(width, rows, ro.device)
    hit = tp1.traverse_packet(scene_arrays, tables, ro.contiguous(),
                              rd.contiguous())
    bro, brd = bounce_wave(ro.cpu(), rd.cpu(), hit.t.cpu())
    dev = ro.device
    return {'prim': (ro[perm].contiguous(), rd[perm].contiguous()),
            'bounce': (torch.as_tensor(bro, device=dev),
                       torch.as_tensor(brd, device=dev))}


# ---------------------------------------------------------------- plain ----

def _visits(stats, key, n):
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def walk_ref(itab, ltab, rays, depth: int, variant: str, stats=None):
    """``kernel_lab.py:40-244``, every program's packets walked side by
    side (the packets of a program share nothing but the loop, and a
    finished packet's steps change nothing). itab f32[Ni, 128], ltab
    f32[Nl, 128] (``split_packet_tables``); rays f32[G * 32, 128]
    (:func:`ray_blocks`). Returns :data:`OUTPUTS`."""
    dev = itab.device
    ni, nl = itab.shape[0], ltab.shape[0]
    Q = rays.shape[0] // RAY_ROWS
    R = rays.view(Q, RAY_ROWS, PACKET)
    O = R[:, 0:3].reshape(Q, 3, 1, PACKET)
    D = R[:, 3:6].reshape(Q, 3, 1, PACKET)
    IV = R[:, 6:9].reshape(Q, 3, 1, PACKET)
    livep = R[:, 10] != 0.0
    sohp = R[:, 11] != 0.0
    d = depth + 2
    t = R[:, 9].clone()
    gid = torch.full((Q, PACKET), -1, dtype=torch.int64, device=dev)
    fnd = torch.zeros((Q, PACKET), dtype=torch.bool, device=dev)
    stk_n = torch.zeros((Q, d + 1), dtype=torch.int64, device=dev)
    stk_m = torch.zeros((Q, d + 1), dtype=torch.int64, device=dev)
    dec = torch.zeros((Q, 4), dtype=torch.int64, device=dev)
    dig = torch.zeros(Q, dtype=torch.int64, device=dev)
    lane_dig = torch.zeros((Q, PACKET), dtype=torch.int64, device=dev)
    mask = torch.zeros(Q, dtype=torch.int64, device=dev)
    sp = torch.zeros(Q, dtype=torch.int64, device=dev)
    cur = torch.where(livep.any(1), 0, DONE)
    qi = torch.arange(Q, device=dev)
    slot = torch.arange(16, device=dev)
    b16 = po.bits16(dev)
    while True:
        alive = cur != DONE
        if not bool(alive.any()):
            break
        leaf = cur < 0
        t_scan = torch.where(livep & ~(sohp & fnd), t,
                             torch.full_like(t, -po.BIG))
        lq = qi[alive & leaf]
        if lq.numel():
            _visits(stats, 'leaf', lq.numel())
            rowL = ltab[po.clamp_rows(~cur[lq], nl)]
            fm = rowL[:, 0:108].reshape(-1, 9, 12, 1)
            ok, tt = po.moller(fm[:, 0:3], fm[:, 3:6], fm[:, 6:9], O[lq],
                               D[lq], 1e-4)
            okm = ok & (tt > 0.0) & (tt < t_scan[lq][:, None])
            ttm = torch.where(okm, tt, torch.full_like(tt, po.BIG))
            leaf_t = ttm.amin(1)
            gids = po.int_bits(rowL[:, 108:120])[:, :, None]
            leaf_gid = torch.where(ttm == leaf_t[:, None], gids,
                                   torch.full_like(gids, 2 ** 30)).amin(1)
            take = okm.any(1)
            tl = t[lq]
            t[lq] = torch.where(take, torch.minimum(tl, leaf_t), tl)
            gid[lq] = torch.where(take & (leaf_t < tl), leaf_gid, gid[lq])
            fnd[lq] = fnd[lq] | take
        iq = qi[alive & ~leaf]
        if iq.numel():
            _visits(stats, 'inner', iq.numel())
            rowI = itab[po.clamp_rows(cur[iq], ni)]
            box = rowI[:, 0:96].reshape(-1, 6, 16, 1)
            tmin, tmax = po.slab_sub(box[:, 0:3], box[:, 3:6], O[iq], IV[iq])
            vis = ((mask[iq][:, None] >> slot) & 1) != 0
            chit = po.slab_hit(tmin, tmax, t_scan[iq][:, None]) & ~vis[:, :, None]
            lane_dig[iq] = po.digest_add(
                lane_dig[iq], (chit.long() << slot[None, :, None]).sum(1))
            if variant != 'nodec':
                nc = po.nearest_child(chit, tmin)
                onehot = (slot[None] == nc['selc'][:, None]) & nc['anyc']
                refs = po.int_bits(rowI[:, 96:112])
                zero = torch.zeros_like(refs)
                selref = torch.where(onehot, refs, zero).sum(-1)
                selbit = torch.where(onehot, b16, zero).sum(-1)
                nh = nc['anyc'].sum(-1)
                if variant == 'packed':
                    word = po.wrap32((((selref + (1 << 24)) << 6) & po.MASK32)
                                     | (nc['selc'] << 2)
                                     | torch.where(nh > 1, 2, 0)
                                     | torch.where(nh > 0, 1, 0))
                    dec[iq, 0] = word
                    dig[iq] = po.digest_add(dig[iq], word)
                else:
                    dec[iq, 0], dec[iq, 1], dec[iq, 2] = selref, selbit, nh
                    dig[iq] = po.digest_add(dig[iq], selref + selbit + nh)
        # the scalar phase
        if variant in ('script', 'nodec'):
            go = alive & (cur < SCRIPT_END)
            if variant == 'nodec':
                go = go & ~leaf
            nxt = torch.where(go, cur + 1, DONE)
        else:
            if variant == 'packed':
                word = dec[:, 0]
                selref = (word >> 6) - (1 << 24)
                selbit = 1 << ((word >> 2) & 15)
                descend = alive & ~leaf & ((word & 1) > 0)
                push = descend & (((word >> 1) & 1) > 0) & (sp < d)
            else:
                selref, selbit, nh = dec[:, 0], dec[:, 1], dec[:, 2]
                descend = alive & ~leaf & (nh > 0)
                push = descend & (nh > 1) & (sp < d)
            stk_n[qi, sp] = torch.where(push, cur, stk_n[qi, sp])
            stk_m[qi, sp] = torch.where(push, mask | selbit, stk_m[qi, sp])
            sp2 = sp + push.long()
            pop = alive & ~descend & (sp2 > 0)
            spr = torch.where(pop, sp2 - 1, sp2)
            nxt = torch.where(descend, selref,
                              torch.where(pop, stk_n[qi, spr], DONE))
            mask = torch.where(descend, 0, torch.where(pop, stk_m[qi, spr], 0))
            sp = torch.where(pop, spr, sp2)
        dig = torch.where(alive, po.digest_add(dig, nxt), dig)
        cur = nxt
    out = torch.stack([t, gid.int().view(torch.float32), fnd.float(),
                       torch.zeros_like(t)], 1).view(Q * 4, PACKET)
    return dict(out=out, stk_n=stk_n.int(), stk_m=stk_m.int(),
                dec_s=dec.int(), digest=dig, lane_digest=lane_dig)


def walk(itab, ltab, rays, depth: int, variant: str):
    """:func:`walk_ref`'s contract. CPU tensors take the plain version; CUDA
    tensors launch ``csrc/probe_packet_walk.cu`` (or raise): one block of
    128 threads per program of 2 packets."""
    if rays.device.type == 'cpu':
        kernels.note_plain(NAME, rays)
        return walk_ref(itab, ltab, rays, depth, variant)
    kernels.require_cuda(NAME, itab, ltab, rays,
                         dtypes=(torch.float32,) * 3)
    if rays.shape[0] % (NPK * RAY_ROWS) or itab.shape[1:] != (PACKET,) \
            or ltab.shape[1:] != (PACKET,):
        raise ValueError(f'{NAME}: rays must be whole programs of {NPK} '
                         f'packets and the tables [N, 128]')
    if depth + 3 > MAX_STACK:
        raise ValueError(f'{NAME}: tree depth {depth} exceeds the kernel '
                         f'stack ({MAX_STACK} entries)')
    programs = rays.shape[0] // (NPK * RAY_ROWS)
    q, d = programs * NPK, depth + 2
    dev = rays.device
    shapes = {'out': (q * 4, PACKET), 'stk_n': (q, d + 1),
              'stk_m': (q, d + 1), 'dec_s': (q, 4), 'digest': (q,),
              'lane_digest': (q, PACKET)}
    outs = {k: torch.empty(s, dtype=torch.float32 if k == 'out'
                           else torch.int32, device=dev)
            for k, s in shapes.items()}
    in_ptrs = (ctypes.c_void_p * 3)(itab.data_ptr(), ltab.data_ptr(),
                                    rays.data_ptr())
    out_ptrs = (ctypes.c_void_p * len(outs))(*(v.data_ptr() for v in outs.values()))
    err = kernels.library().cpt_probe_packet_walk(
        VARIANTS.index(variant), in_ptrs, out_ptrs, itab.shape[0],
        ltab.shape[0], programs, d, kernels.stream_of(rays))
    kernels.LAUNCHES[NAME] += 1
    kernels.check(err, NAME)
    for k in ('digest', 'lane_digest'):
        outs[k] = outs[k].long() & po.MASK32
    return outs


# --------------------------------------------------------------- sweeps ----

def setup(device: str = 'cuda', small: bool = False):
    """The port's scene, tables and the lab's two waves as ray blocks.
    Full size: sibenik, 1920 x 192 rows of a 1080-high frame (1,440
    programs). Small (the CPU): ``outside`` (the cubes, no planes in the
    tables) at 64 x 8 rows of a 48-high frame (2 programs)."""
    from ..scene import builder
    scene = builder.get_scene('outside' if small else 'sibenik')
    arrays, dyn = scene.to_device(device), scene.dynamic_arrays(device)
    tables = tp1.PacketTables(dyn.packet_inner, dyn.packet_leaf, dyn.depth)
    if small:
        cam = cam_mod.Camera.create([0.0, 0.0, 5.0], [0.0, 0.0, 1.0], 1.5,
                                    12.0, 0.0, device=device)
        rays = waves(arrays, tables, cam, 64, 8, 48, y0=20)
    else:
        cam = cam_mod.Camera.create(device=device, **CAMERA)
        rays = waves(arrays, tables, cam, 1920, 192, 1080)
    blocks = {w: ray_blocks(*rays[w]) for w in WAVES}
    merged = tp2.MergedTable(dyn.packet_merged, dyn.depth)
    return dict(tables=tables, merged=merged, rays=rays, blocks=blocks)


def cases():
    return [(w, v) for w in WAVES for v in VARIANTS]


def probe(device: str = 'cuda', small: bool = False, reps: int = 3,
          setup_=None):
    """Every variant on both waves through :func:`walk` (the main path)."""
    s = setup_ or setup(device, small)
    tb = s['tables']
    rows = []
    for wave, variant in cases():
        blocks = s['blocks'][wave]
        fn = lambda: walk(tb.inner, tb.leaf, blocks, tb.depth, variant)  # noqa: E731
        if device != 'cpu':
            ms, out = timing.cuda_ms(fn, reps=reps, warmup=1, preroll=True)
        else:
            ms, out = None, fn()
        rows.append(dict(site='kernel_lab.py:256', wave=wave, variant=variant,
                         label=f'{wave} {variant}', out=out, ms=ms,
                         rays=blocks.shape[0] // RAY_ROWS * PACKET, setup=s))
    return rows



def lab_t(out):
    """The walk's t per ray, in walk order."""
    return out['out'].view(-1, 4, PACKET)[:, 0].reshape(-1)


def compare(rows):
    """Every case against the plain walk, bit for bit (digests included);
    the lab's own [MATCH] check (v0, packed and phase give the same t); and,
    per wave, the port's traversals on the same rays: ``traverse_split``
    (v1, 16-lane groups) and ``traverse_merged`` (v2), their times and the
    rays whose t differs from the packet walk's. v0 on the primary wave
    gets the plain walk's time and the bound (both tables read once, the
    rays and outputs; its visits' FP32 operations)."""
    ref = {}
    for r in rows:
        s = r['setup']
        tb = s['tables']
        blocks = s['blocks'][r['wave']]
        stats = {}
        fn = lambda: walk_ref(tb.inner, tb.leaf, blocks, tb.depth,  # noqa: E731
                              r['variant'], stats)
        kernels.note_plain(NAME, blocks)
        if blocks.is_cuda and (r['wave'], r['variant']) == ('prim', 'v0'):
            r['plain_ms'], want = timing.cuda_ms(fn)
            n_bytes = (tb.inner.numel() + tb.leaf.numel()) * 4 \
                + blocks.numel() * 4 + sum(v.numel() * 4
                                           for v in want.values())
            r['bound_ms'], r['bound_by'] = timing.bound(
                n_bytes, PACKET * (stats['inner'] * INNER_OPS
                                   + stats['leaf'] * LEAF_OPS))
        else:
            want = fn()
        r['visits'] = stats
        r['equal'] = po.same(r['out'], want)
        # over t only: the gid rows are int bits (-1 reads as a NaN)
        r['max_abs_err'] = float((lab_t(r['out']) - lab_t(want)).abs().max())
        if r['variant'] in ('v0', 'packed', 'phase'):
            key = r['wave']
            tv = lab_t(r['out'])
            if key not in ref:
                ref[key] = tv
            else:
                r['match'] = bool(torch.equal(ref[key].view(torch.int32),
                                              tv.view(torch.int32)))
    for wave in WAVES:
        r0 = next(r for r in rows if (r['wave'], r['variant']) == (wave, 'v0'))
        _against_traversals(r0)
    return rows


def _against_traversals(r):
    """The port's two traversal kernels on the wave's rays (t0 = 1.5e38,
    every ray live, closest hit): times, and the rays whose t differs from
    the packet walk's (expected only on exact ties)."""
    s = r['setup']
    ro, rd = s['rays'][r['wave']]
    b = ro.shape[0]
    t0 = torch.full((b,), 1.5e38, dtype=torch.float32, device=ro.device)
    live = torch.ones(b, dtype=torch.bool, device=ro.device)
    stop = torch.zeros_like(live)
    fns = {'traverse_split': lambda: tp1.traverse_split(
               s['tables'], ro, rd, t0, live, stop),
           'traverse_merged': lambda: tp2.traverse_merged(
               s['merged'], ro, rd, t0, live, stop)}
    lab = lab_t(r['out'])
    for name, fn in fns.items():
        if ro.is_cuda:
            ms, res = timing.cuda_ms(fn, reps=3, warmup=1, preroll=True)
        else:
            ms, res = None, fn()
        r[f'{name}_ms'] = ms
        r[f'{name}_t_diff'] = int((res[0].view(torch.int32)
                                   != lab.view(torch.int32)).sum())


def hopper_question(rows):
    """ms and Mrays/s per variant and wave, beside the port's traversals;
    the [MATCH] check; the rays whose t differs from traverse_split's."""
    lines = []
    for r in rows:
        note = ''
        if 'match' in r:
            note = '  [MATCH]' if r['match'] else '  [MISMATCH!]'
        v = r.get('visits', {})
        lines.append(f"kernel_lab.py:256 {r['wave']:6s} {r['variant']:6s}: "
                     f"{r['ms']:8.3f} ms, {r['rays'] / r['ms'] / 1e3:8.2f} "
                     f"Mrays/s, {v.get('inner', 0)} inner + {v.get('leaf', 0)} "
                     f"leaf packet-visits{note}")
        if r['variant'] == 'v0':
            for name in ('traverse_split', 'traverse_merged'):
                lines.append(
                    f"  {name} on the same {r['rays']} rays: "
                    f"{r[name + '_ms']:.4f} ms, "
                    f"{r['rays'] / r[name + '_ms'] / 1e3:.2f} Mrays/s; t "
                    f"differs from the packet walk on {r[name + '_t_diff']} "
                    f"rays")
    return lines


def answer(rows) -> str:
    ok = all(r['equal'] for r in rows)
    match = all(r.get('match', True) for r in rows)
    if rows[0]['ms'] is None:
        return (f'lab_v1_probe: {len(rows)} cases, plain only, ok={ok}, '
                f'match={match}')
    v0 = {r['wave']: r for r in rows if r['variant'] == 'v0'}
    parts = [f"{w} packet walk {v0[w]['ms']:.3f} ms vs groups v1 "
             f"{v0[w]['traverse_split_ms']:.3f} / v2 "
             f"{v0[w]['traverse_merged_ms']:.3f} ms" for w in WAVES]
    return (f'lab_v1_probe: {"; ".join(parts)}; [MATCH]={match}; '
            f'bit-equal={ok}')


def summary(rows):
    """The kernel's line for ``chip_smoke.py``: v0 on the primary wave."""
    r = next(x for x in rows if (x['wave'], x['variant']) == ('prim', 'v0'))
    return dict(max_abs_err=max(x['max_abs_err'] for x in rows), ms=r['ms'],
                plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                bound_by=r['bound_by'], library_ms=None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    cpu = args.device == 'cpu'
    if not cpu:
        timing.require_card()
        print('card:', timing.card_line())
    rows = compare(probe(args.device, small=cpu))
    if not cpu:
        for line in hopper_question(rows):
            print(line)
    print(answer(rows))
    return 0 if all(r['equal'] for r in rows) and all(
        r.get('match', True) for r in rows) else 1


if __name__ == '__main__':
    sys.exit(main())
