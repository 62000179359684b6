"""Run the Pallas probe kernels of the repo's ``tools/`` in interpret mode
at small sizes and save their outputs with their inputs, for
``test_torch_probes.py``. Usage: ``python _torch_jax_probes.py FAMILY
OUT.npz`` with FAMILY one of gather, slab, step, onehot.

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
    {'gather': gather, 'slab': slab, 'step': step, 'onehot': onehot}[family](
        results)
    np.savez(path, **results)
