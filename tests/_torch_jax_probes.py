"""Run the Pallas probe kernels of the repo's ``tools/`` in interpret mode
at small sizes and save their outputs with their inputs, for
``test_torch_probes.py`` (FAMILY gather, slab, step, onehot) and
``test_torch_probes_lab.py`` (packet_step, decision, visit, lab_v1, which
also save the scratch each kernel leaves). Usage: ``python
_torch_jax_probes.py FAMILY OUT.npz``.

A probe file runs its benchmark at import, so it is not imported: its source
is parsed with ``ast`` and only its imports and ``def``s run, in a namespace
given small values of its module constants. Its ``pl`` is then replaced by a
view of ``jax.experimental.pallas`` whose ``pallas_call`` adds
``interpret=True``, so the probe's own calls (``run``, ``make``'s ``run``,
``try_one``) keep their specs. Where the call sits in module-level code,
this file rebuilds it with the probe's own specs and names the lines.

Runs in its own process so the test can give XLA ``--xla_cpu_max_isa=AVX``
(no FMA contraction of ``a*b + c``) and ``--xla_allow_excess_precision=false``
(bf16 rounded after every op), the rounding of the port's plain versions.
"""
import ast
import functools
import os
import sys
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pallas  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

VMEM = pltpu.VMEM


def interpreting_pallas():
    view = types.SimpleNamespace(**{k: getattr(pallas, k) for k in dir(pallas)
                                    if not k.startswith('__')})
    view.pallas_call = functools.partial(pallas.pallas_call, interpret=True)
    return view


def load_probe(name: str, **consts):
    """The imports and defs of ``tools/<name>``, run with ``consts`` as
    module globals; ``pl`` interprets."""
    path = os.path.join(REPO, 'tools', name)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    keep = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    ns = dict(consts, __name__=f'probe_{name[:-3]}')
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, 'exec'), ns)
    ns['pl'] = interpreting_pallas()
    return ns


def call(kernel, out_shape, *args, scratch=None):
    """The probes' common call: every input and the output whole in VMEM."""
    return pallas.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[pallas.BlockSpec(memory_space=VMEM)] * len(args),
        out_specs=pallas.BlockSpec(memory_space=VMEM),
        scratch_shapes=scratch or [], interpret=True)(*args)


def scratch_call(kernel, args, out_shapes, scratch, copy=None, grid=None,
                 in_specs=None, out_specs=None, **params):
    """``pallas_call`` of a probe kernel with its own specs (or every array
    whole in VMEM) that also returns the scratch the kernel leaves: a
    wrapper zeroes the scratch refs before the body (uninitialized SMEM
    reads INT_MIN and VMEM NaN in interpret mode; the port zeroes its
    scratch) and copies the ones named in ``copy`` (indices, default all)
    to extra outputs after it, one block per program when there is a
    grid."""
    n_in, n_out = len(args), len(out_shapes)
    copy = list(range(len(scratch))) if copy is None else list(copy)

    def wrapped(*refs):
        ins, outs = refs[:n_in], refs[n_in:n_in + n_out]
        extra = refs[n_in + n_out:n_in + n_out + len(copy)]
        scr = refs[n_in + n_out + len(copy):]
        for k in copy:
            scr[k][...] = jnp.zeros(scr[k].shape, scr[k].dtype)
        kernel(*ins, *outs, *scr)
        for e, k in zip(extra, copy):
            e[...] = scr[k][...]
    extra_shapes = [jax.ShapeDtypeStruct(
        ((grid[0] if grid else 1) * scratch[k].shape[0],) + scratch[k].shape[1:],
        scratch[k].dtype) for k in copy]
    if grid:
        extra_specs = [pallas.BlockSpec(scratch[k].shape, lambda g: (g, 0),
                                        memory_space=VMEM) for k in copy]
    else:
        extra_specs = [pallas.BlockSpec(memory_space=VMEM)] * len(copy)
    res = pallas.pallas_call(
        wrapped,
        out_shape=tuple(jax.ShapeDtypeStruct(s, d) for s, d in out_shapes)
        + tuple(extra_shapes),
        in_specs=in_specs or [pallas.BlockSpec(memory_space=VMEM)] * n_in,
        out_specs=tuple(out_specs or [pallas.BlockSpec(memory_space=VMEM)]
                        * n_out) + tuple(extra_specs),
        scratch_shapes=scratch, interpret=True,
        **(dict(grid=grid) if grid else {}), **params)(*args)
    return [np.asarray(r) for r in res]


def packet_step(out):
    from cuda_pathtracer_tpu_torch.tools import packet_step_probe as ps
    f32, i32 = jnp.float32, jnp.int32
    SMEM = pltpu.SMEM
    for k, (site, variant, t) in enumerate(ps.cases(True)):
        ins = {n: jnp.asarray(v) for n, v in ps.inputs(site, variant,
                                                        True).items()}
        if site == 'r2f':
            ns = load_probe('pallas_probe_r2f.py', N=ins['tab'].shape[0],
                            ARITY=16)
            # pallas_probe_r2f.py:96-100
            res = scratch_call(ns['make'](t, variant),
                               [ins['tab'], ins['ro'], ins['ird']],
                               [((3 * variant, 128), f32)],
                               [SMEM((variant, 64), i32)])
        elif site == 'r2g':
            ns = load_probe('pallas_probe_r2g.py', N=ins['tab'].shape[0],
                            ARITY=16, LEAF_MAX=12, BOX0=1, REFS0=97, TRIS0=1,
                            GIDS0=109, BIG=3.0e38)
            # pallas_probe_r2g.py:158-166
            res = scratch_call(ns['make'](t, variant, 0.5),
                               [ins['tab'], ins['o'], ins['inv'], ins['d']],
                               [((variant, 128), f32), ((variant, 128), i32)],
                               [SMEM((variant, 32), i32),
                                SMEM((variant, 32), i32)])
        elif site == 'r2h':
            ns = load_probe('pallas_probe_r2h.py', NI_=ins['itab'].shape[0],
                            NL_=ins['ltab'].shape[0], ARITY=16, LEAF_MAX=12,
                            BIG=3.0e38, NPK=ps.R2H_NPK)
            npk = ps.R2H_NPK
            # pallas_probe_r2h.py:172-182
            res = scratch_call(ns['make'](t, variant),
                               [ins[n] for n in ps.INPUT_ORDER['r2h']],
                               [((npk, 128), f32)],
                               [SMEM((npk, 32), i32), SMEM((npk, 32), i32),
                                VMEM((npk, 128), f32), SMEM((npk, 4), i32)],
                               compiler_params=pltpu.CompilerParams(
                                   vmem_limit_bytes=120 * 1024 * 1024))
        else:
            ns = load_probe('pallas_probe_r2i.py', N=ins['tab'].shape[0],
                            BIG=3.0e38)
            # pallas_probe_r2i.py:68-73
            res = scratch_call(ns['make'](t, variant), [ins['tab'], ins['o']],
                               [((8, 128), f32)], [])
        for name, v in zip([n for n in ps.OUTPUTS[site] if n != 'digest'],
                           res):
            out[f'{name}_{k}'] = v


def decision(out):
    from cuda_pathtracer_tpu_torch.tools import decision_probe as dp
    f32, i32 = jnp.float32, jnp.int32
    ins = {site: {k: jnp.asarray(v) for k, v in dp.inputs(site, True).items()}
           for site in ('lab2', 'mosaic')}
    for k, (site, variant, t) in enumerate(dp.cases(True)):
        if site == 'lab2':
            itab, rays = ins[site]['itab'], ins[site]['rays']
            g = rays.shape[0] // (dp.NPK * 12)
            ns = load_probe('kernel_lab2.py', ARITY=16, N=itab.shape[0], T=t,
                            NPK=dp.NPK, BIG=3.0e38)
            # kernel_lab2.py:132-144
            res = scratch_call(
                ns['make_kernel'](variant), [itab, rays],
                [((g * 8, 128), f32)],
                [pltpu.SMEM((dp.NPK, 4), i32), VMEM((dp.NPK, 128), f32)],
                copy=[0], grid=(g,),
                in_specs=[pallas.BlockSpec(memory_space=VMEM),
                          pallas.BlockSpec((dp.NPK * 12, 128),
                                           lambda i: (i, 0),
                                           memory_space=VMEM)],
                out_specs=[pallas.BlockSpec((8, 128), lambda i: (i, 0),
                                            memory_space=VMEM)])
        else:
            tab, rays = ins[site]['tab'], ins[site]['rays']
            ns = load_probe('mosaic_bisect.py', N=tab.shape[0], STEPS=t,
                            PMETA=96)
            rung = int(variant[1])
            # mosaic_bisect.py:166-174
            res = scratch_call(
                ns['mk_rays' if rung >= 7 else 'mk'](variant),
                [tab, rays] if rung >= 7 else [tab], [((1, 128), f32)],
                [pltpu.SMEM((3, 8), i32), VMEM((1, 128), f32)])
        for name, v in zip([n for n in dp.OUTPUTS[site] if n != 'digest'],
                           res):
            out[f'{name}_{k}'] = v


def visit(out):
    from cuda_pathtracer_tpu_torch.tools import visit_probe as vp
    f32, i32 = jnp.float32, jnp.int32
    SMEM = pltpu.SMEM
    ins = {site: {k: jnp.asarray(v) for k, v in vp.inputs(site, True).items()}
           for site in ('lab3', 'subpacket')}
    for k, (site, variant, t, sets) in enumerate(vp.cases(True)):
        tab, rays = ins[site]['tab'], ins[site]['rays']
        if site == 'lab3':
            ns = load_probe('kernel_lab3.py', ARITY=16, LEAF_MAX=12,
                            N=tab.shape[0], T=t, NPK=vp.NPK, BIG=3.0e38,
                            MT_DET_EPS=1e-4, PBOX0=0, PTRIS=0, PGIDS=108)
            btab = ns['pack_bf16'](tab)          # kernel_lab3.py:459-467
            out['btab'] = np.asarray(btab)
            g = rays.shape[0] // (vp.NPK * 16)
            # kernel_lab3.py:483-497
            res = scratch_call(
                ns['make_kernel'](variant), [tab, btab, rays],
                [((g * 8, 128), f32)],
                [SMEM((vp.NPK, 4), i32), VMEM((vp.NPK, 128), f32)],
                copy=[0], grid=(g,),
                in_specs=[pallas.BlockSpec(memory_space=VMEM),
                          pallas.BlockSpec(memory_space=VMEM),
                          pallas.BlockSpec((vp.NPK * 16, 128),
                                           lambda i: (i, 0),
                                           memory_space=VMEM)],
                out_specs=[pallas.BlockSpec((8, 128), lambda i: (i, 0),
                                            memory_space=VMEM)])
        else:
            ns = load_probe('subpacket_probe.py', ARITY=16, LEAF_MAX=12,
                            PTRIS=0, PGIDS=108, PMETA=96, PBOX0=0, NGROUP=8,
                            GW=16, N=tab.shape[0], STEPS=t, SETS=sets,
                            DECW=vp.DECW, BIG=vp.BIG_SUB, MT_DET_EPS=1e-4)
            # subpacket_probe.py:280-304
            if variant == 'v2ref':
                kern = ns['_mk_v2ref']()
                scratch, copy = [SMEM((3, 8), i32), VMEM((1, 128), f32)], None
            elif variant in ('dec_mxu', 'full'):
                kern = ns['_mk'](variant)
                scratch = [VMEM((8, 128), f32), VMEM((8, vp.DECW), i32),
                           SMEM((8, vp.DECW), i32), SMEM((3, 8), i32),
                           VMEM((1, 128), f32), pltpu.SemaphoreType.DMA]
                copy = [0, 1, 2, 3, 4]
            else:
                kern = ns['_mk'](variant)
                scratch = [VMEM((8, 128), f32), SMEM((3, 8), i32),
                           VMEM((1, 128), f32)]
                copy = None
            res = scratch_call(kern, [tab, rays], [((1, 128), f32)], scratch,
                               copy=copy,
                               compiler_params=pltpu.CompilerParams(
                                   vmem_limit_bytes=120 * 1024 * 1024))
        for name, v in zip([n for n in vp.outputs(site, variant)
                            if n != 'digest'], res):
            out[f'{name}_{k}'] = v


def lab_v1(out):
    """``kernel_lab.py``'s variants on small waves of the test room: 64 x 8
    rows (20-27 of a 48-high frame) of pinhole rays in 8 x 16 tiles, and a
    bounce wave from their v1 hits (2 programs of 2 packets each)."""
    from _torch_room import build_room, CAMERA
    from cuda_pathtracer_tpu.core import camera as jcam
    from cuda_pathtracer_tpu.ops import intersect as isect
    from cuda_pathtracer_tpu.ops import traverse_packet as tpk
    from cuda_pathtracer_tpu.scene import scene as js
    from cuda_pathtracer_tpu_torch.scene.builder import add_cube
    from cuda_pathtracer_tpu_torch.tools import lab_v1_probe as lp
    f32, i32 = jnp.float32, jnp.int32
    scene = build_room(js, add_cube)
    dyn = scene.dynamic_arrays()
    # kernel_lab.py:282-283 (traverse_packet.py:107)
    tables = tpk.split_packet_tables(np.asarray(dyn.wide_rows),
                                     scene.wide_depth)
    out['inner'], out['leaf'] = np.asarray(tables.inner), np.asarray(tables.leaf)
    out['depth'] = tables.depth
    W, H, FH, Y0 = 64, 8, 48, 20
    B = W * H
    ys, xs = np.mgrid[Y0:Y0 + H, 0:W]
    ro, rd = jcam.generate_rays_simple(jcam.Camera.create(**CAMERA),
                                       jnp.asarray(xs.ravel()),
                                       jnp.asarray(ys.ravel()), W, FH)
    out['ro'], out['rd'] = np.asarray(ro), np.asarray(rd)
    perm = np.arange(B).reshape(H // 8, 8, W // 16, 16).transpose(
        0, 2, 1, 3).reshape(-1)
    PACKET, RAY_ROWS = tpk.PACKET, tpk.RAY_ROWS

    def ray_blocks(ro_, rd_):             # kernel_lab.py:288-297
        inv = isect.safe_inv_dir(rd_)
        t0 = jnp.full((B,), 3.0e38 / 2, jnp.float32)
        M = jnp.concatenate([
            ro_, rd_, inv, t0[:, None],
            jnp.ones((B, 1), jnp.float32),
            jnp.zeros((B, 1), jnp.float32),
            ro_ * inv, jnp.zeros((B, 1), jnp.float32)], axis=1)
        rays = jnp.swapaxes(M.reshape(-1, PACKET, RAY_ROWS), -1, -2)
        return rays.reshape(-1, PACKET)

    waves = {'prim': ray_blocks(ro[perm], rd[perm])}
    # kernel_lab.py:303-326, the v1 kernel in interpret mode
    h = tpk.traverse_packet(scene.to_device(), tables, ro, rd, interpret=True)
    hitn = np.asarray(h.t)
    out['hit_t'] = hitn
    ron, rdn = np.asarray(ro), np.asarray(rd)
    hp = (ron + rdn * (np.minimum(hitn, 100.0)[:, None] - 1e-3)).astype(
        np.float32)
    rng = np.random.default_rng(1)
    d2 = rng.normal(size=(B, 3)).astype(np.float32)
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
    oct_ = ((d2[:, 0] > 0).astype(np.int64)
            | ((d2[:, 1] > 0).astype(np.int64) << 1)
            | ((d2[:, 2] > 0).astype(np.int64) << 2))
    om = np.argsort((morton << 3) | oct_, kind='stable')
    waves['bounce'] = ray_blocks(jnp.asarray(hp[om]), jnp.asarray(d2[om]))
    ns = load_probe('kernel_lab.py', ARITY=16, LEAF_MAX=12, PBOX0=tpk.PBOX0,
                    PREFS=tpk.PREFS, PTRIS=tpk.PTRIS, PGIDS=tpk.PGIDS,
                    RAY_ROWS=RAY_ROWS, PACKET=PACKET, DONE=tpk.DONE,
                    BIG=tpk.BIG, MT_DET_EPS=tpk.MT_DET_EPS, NPK=lp.NPK)
    d = tables.depth + 2
    npk = lp.NPK
    for wave, rays in waves.items():
        out[wave] = np.asarray(rays)
        gn = rays.shape[0] // (npk * RAY_ROWS)
        for variant in lp.VARIANTS:
            # kernel_lab.py:247-270
            res = scratch_call(
                ns['variant_kernel'](variant, d),
                [tables.inner, tables.leaf, rays],
                [((gn * npk * 4, PACKET), f32)],
                [pltpu.SMEM((npk, d + 1), i32), pltpu.SMEM((npk, d + 1), i32),
                 VMEM((npk, PACKET), f32), VMEM((npk, PACKET), i32),
                 VMEM((npk, PACKET), i32), pltpu.SMEM((npk, 4), i32)],
                copy=[0, 1, 5], grid=(gn,),
                in_specs=[pallas.BlockSpec(memory_space=VMEM)] * 2
                + [pallas.BlockSpec((npk * RAY_ROWS, PACKET),
                                    lambda g: (g, 0), memory_space=VMEM)],
                out_specs=[pallas.BlockSpec((npk * 4, PACKET),
                                            lambda g: (g, 0),
                                            memory_space=VMEM)],
                compiler_params=pltpu.CompilerParams(
                    vmem_limit_bytes=120 * 1024 * 1024))
            for name, v in zip(('out', 'stk_n', 'stk_m', 'dec_s'), res):
                out[f'{wave}_{variant}_{name}'] = v


def gather(out):
    from cuda_pathtracer_tpu_torch.tools import gather_probe as gp
    for k, (site, label, mode, tab, idx, steps) in enumerate(gp.sites(True)):
        if mode == gp.CHASE:
            continue          # the card's own question; no TPU kernel
        name = site.split(':')[0]
        if name == 'pallas_gather_probe1.py':
            ns = load_probe(name, N=tab.shape[0], B=idx.shape[0])
            # pallas_gather_probe1.py:16-22
            got = call(ns['kernel'], (idx.shape[0], 8), tab, idx)
        elif name == 'pallas_gather_probe2.py':
            ns = load_probe(name, N=tab.shape[0], B=idx.shape[0])
            # pallas_gather_probe2.py:12-16 and :27-31
            got = call(ns['k1'], idx.shape, tab, idx)
        elif name == 'pallas_gather_probe3.py':
            ns = load_probe(name)
            # pallas_gather_probe3.py:12-16
            got = call(ns['k'], idx.shape, tab, idx)
        elif name == 'pallas_probe_r2a.py':
            b = idx.shape[-1]
            ns = load_probe(name, N=tab.shape[0], B=b)
            kern = {gp.ROWS: 'k_rowgather', gp.TAA1: 'k_taa1',
                    gp.ROWSUM: 'k_scalar_rows'}[mode]
            shape = {gp.ROWS: (b, tab.shape[1]), gp.TAA1: idx.shape,
                     gp.ROWSUM: (1, tab.shape[1])}[mode]
            st, got = ns['try_one'](kern, ns[kern],
                                    jax.ShapeDtypeStruct(shape, jnp.float32),
                                    jnp.asarray(tab), jnp.asarray(idx))
            assert st == 'OK', got
            if mode == gp.ROWS:   # jnp.take (r2a.py:56-59), the same rows
                st, take = ns['try_one']('take', ns['k_take'],
                                         jax.ShapeDtypeStruct(shape,
                                                              jnp.float32),
                                         jnp.asarray(tab), jnp.asarray(idx))
                assert st == 'OK', take
                out[f'take_{k}'] = np.asarray(take)
        else:
            n = tab.shape[0]

            def kern(t_ref, o_ref):      # pallas_probe_r2f.py:15-16
                o_ref[:] = t_ref[0:8, :] + t_ref[n - 8:n, :]
            # pallas_probe_r2f.py:18-24
            got = pallas.pallas_call(
                kern, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                in_specs=[pallas.BlockSpec(memory_space=VMEM)],
                out_specs=pallas.BlockSpec(memory_space=VMEM),
                compiler_params=pltpu.CompilerParams(
                    vmem_limit_bytes=128 * 1024 * 1024),
                interpret=True)(tab)
        out[f'out_{k}'] = np.asarray(got)


def slab(out):
    from cuda_pathtracer_tpu_torch.tools import bf16_probe as bp
    k, r = 8, 1
    ns = load_probe('bf16_vpu_probe.py', K=k, R=r)
    x32 = jnp.asarray(bp.inputs(r))
    x16 = x32.astype(jnp.bfloat16)
    out['x'] = np.asarray(x32)
    out['k'] = k
    for label, v in bp.VARIANTS.items():
        dtype = jnp.float32 if v == bp.F32 else jnp.bfloat16
        run = ns['make'](dtype, v == bp.WIDEN)        # bf16_vpu_probe.py:54-61
        got = run(x32 if v == bp.F32 else x16)
        out[f'out_{v}'] = np.asarray(got.astype(jnp.float32))


def step(out):
    from cuda_pathtracer_tpu_torch.tools import step_probe as sp
    tab, rays = sp.inputs(16)
    out['tab'], out['rays'] = tab, rays
    scratch = lambda ni: [pltpu.SMEM((ni, 64) if ni else (64,), jnp.int32),  # noqa: E731
                          pltpu.SMEM((1, 1), jnp.float32)]
    for k, (site, label, flags, ni, batched, t) in enumerate(sp.cases(True)):
        name = site.split(':')[0]
        if name == 'pallas_probe_r2b.py':
            ns = load_probe(name, N=tab.shape[0], T=t)
            # pallas_probe_r2b.py:49-57
            got = call(ns['kernel'], (8, 128), tab, rays, scratch=scratch(0))
        elif name == 'pallas_probe_r2c.py':
            ns = load_probe(name, N=tab.shape[0], T=t)
            # pallas_probe_r2c.py:62-68
            got = call(ns['make'](*flags), (8, 128), tab, rays,
                       scratch=scratch(0))
        elif name == 'pallas_probe_r2d.py':
            ns = load_probe(name, N=tab.shape[0])
            # pallas_probe_r2d.py:52-57
            got = call(ns['make'](t, *flags), (8, 128), tab, rays,
                       scratch=scratch(0))
        else:
            ns = load_probe(name, N=tab.shape[0])
            # pallas_probe_r2e.py:62-67
            got = call(ns['make'](t, ni, batched), (8, 128), tab, rays,
                       scratch=scratch(ni))
        out[f'out_{k}'] = np.asarray(got)


def onehot(out):
    from cuda_pathtracer_tpu_torch.tools import onehot_probe as op
    steps = 16
    out['steps'] = steps
    for k, (site, n, bf16, cells, chains) in enumerate(op.cases(True)):
        tab, idx = op.case_inputs(site, n, cells, chains)
        name = site.split(':')[0]
        ns = load_probe(name, T=steps, G=cells)
        if name == 'pallas_probe_onehot.py':
            got = ns['run'](jnp.asarray(tab), jnp.asarray(idx), n_rows=n,
                            bf16=bf16, t_steps=steps)
        elif name == 'pallas_probe_onehot2.py':
            got = ns['run'](jnp.asarray(tab), jnp.asarray(idx), n_rows=n,
                            p_chains=chains, t_steps=steps)
        else:
            got = ns['run'](jnp.asarray(tab), jnp.asarray(idx), n_rows=n,
                            t_steps=steps, width=chains)
        out[f'out_{k}'] = np.asarray(got)


if __name__ == '__main__':
    family, path = sys.argv[1], sys.argv[2]
    results = {}
    {'gather': gather, 'slab': slab, 'step': step, 'onehot': onehot,
     'packet_step': packet_step, 'decision': decision,
     'visit': visit, 'lab_v1': lab_v1}[family](results)
    np.savez(path, **results)
