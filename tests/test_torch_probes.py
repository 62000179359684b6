"""The port's probe modules (``cuda_pathtracer_tpu_torch/tools/``) against
the Pallas probes of the repo's ``tools/`` they stand for, 14 ``pallas_call``
sites in 13 files, at small sizes on the CPU.

The probes run in interpret mode in subprocesses (``_torch_jax_probes.py``,
one per family, in parallel) with XLA limited to AVX, so ``a*b + c`` is not
contracted into an FMA, and with ``--xla_allow_excess_precision=false``, so
bf16 rounds after every op as torch does. The same numpy inputs from a seed
go through the port's plain versions. Bounds: every output bit for bit,
bf16 ones included (a bf16 product or difference computed in f32 and
rounded is the correctly rounded bf16 result, in both frameworks).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cuda_pathtracer_tpu_torch.tools import (bf16_probe, gather_probe,
                                             onehot_probe, step_probe)

HERE = os.path.dirname(os.path.abspath(__file__))
FAMILIES = ('gather', 'slab', 'step', 'onehot')
GATHER_CASES = [(k, c) for k, c in enumerate(gather_probe.sites(small=True))
                if c[2] != gather_probe.CHASE]
STEP_CASES = list(enumerate(step_probe.cases(small=True)))
ONEHOT_CASES = list(enumerate(onehot_probe.cases(small=True)))


@pytest.fixture(scope='module')
def jax_out(tmp_path_factory):
    out = tmp_path_factory.mktemp('jax_probes')
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               XLA_FLAGS='--xla_cpu_max_isa=AVX '
                         '--xla_allow_excess_precision=false')
    procs = {f: subprocess.Popen(
        [sys.executable, os.path.join(HERE, '_torch_jax_probes.py'), f,
         str(out / f'{f}.npz')], env=env, cwd=HERE,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE) for f in FAMILIES}
    for f, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, f'{f}: ' + err.decode()[-3000:]
    return {f: dict(np.load(out / f'{f}.npz')) for f in FAMILIES}


def _bits(x):
    x = x.float() if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize('k,case', GATHER_CASES,
                         ids=[f'{c[0]}-{c[1]}' for _, c in GATHER_CASES])
def test_gather_sites_match_jax(jax_out, k, case):
    site, label, mode, tab, idx, steps = case
    got = gather_probe.gather(mode, torch.as_tensor(tab), torch.as_tensor(idx),
                              steps)
    want = jax_out['gather'][f'out_{k}']
    assert tuple(got.shape) == want.shape
    assert torch.equal(_bits(got), _bits(want))
    if f'take_{k}' in jax_out['gather']:          # r2a's jnp.take
        assert torch.equal(_bits(got), _bits(jax_out['gather'][f'take_{k}']))


def test_gather_chase_follows_column_zero():
    """CHASE, the card's dependent-read mode (no TPU kernel): the plain
    version against a numpy replay of the chains."""
    site, label, mode, tab, idx, steps = gather_probe.sites(small=True)[-1]
    assert mode == gather_probe.CHASE
    got = gather_probe.gather(mode, torch.as_tensor(tab), torch.as_tensor(idx),
                              steps).numpy()
    cur, acc = idx.astype(np.int64), np.zeros((idx.size, tab.shape[1]),
                                              np.float32)
    for _ in range(steps):
        acc = acc + tab[cur]
        cur = tab[cur, 0].astype(np.int64)
    np.testing.assert_array_equal(got.view(np.int32), acc.view(np.int32))


@pytest.mark.parametrize('label', list(bf16_probe.VARIANTS))
def test_slab_matches_jax(jax_out, label):
    z = jax_out['slab']
    v = bf16_probe.VARIANTS[label]
    x = torch.as_tensor(z['x'])
    if v != bf16_probe.F32:
        x = x.to(torch.bfloat16)
    got = bf16_probe.slab(v, x, int(z['k']))
    assert got.dtype == x.dtype
    assert torch.equal(_bits(got), _bits(z[f'out_{v}']))


@pytest.mark.parametrize('k,case', STEP_CASES,
                         ids=[f'{c[0]}-{c[1]}-T{c[5]}' for _, c in STEP_CASES])
def test_step_matches_jax(jax_out, k, case):
    z = jax_out['step']
    site, label, flags, ni, batched, t = case
    got = step_probe.step(torch.as_tensor(z['tab']), torch.as_tensor(z['rays']),
                          t, flags, ni, batched)
    assert torch.equal(_bits(got), _bits(z[f'out_{k}']))


@pytest.mark.parametrize('k,case', ONEHOT_CASES,
                         ids=[f'{c[0]}-N{c[1]}-{"bf16" if c[2] else "f32"}-'
                              f'P{c[4]}' for _, c in ONEHOT_CASES])
def test_onehot_matches_jax(jax_out, k, case):
    site, n, bf16, cells, chains = case
    steps = int(jax_out['onehot']['steps'])
    tab, idx = onehot_probe.case_inputs(site, n, cells, chains)
    table = onehot_probe.Table(torch.as_tensor(tab), bf16)
    starts = onehot_probe.starts_of(site, torch.as_tensor(idx), cells, chains)
    cur, acc = onehot_probe.fetch('mma', table, starts, steps)
    got = onehot_probe.tpu_layout(site, cur, acc).reshape(cells, -1, 128)
    want = torch.as_tensor(jax_out['onehot'][f'out_{k}']).reshape(cells, -1,
                                                                  128)
    # onehot3 leaves the rows past 2 W unwritten
    rows = 2 * chains if site.startswith('pallas_probe_onehot3') else None
    assert got.shape == want.shape
    assert torch.equal(_bits(got[:, :rows]), _bits(want[:, :rows]))
    assert int(cur.min()) >= 0 and int(cur.max()) < n


@pytest.mark.parametrize('bf16', [True, False])
def test_onehot_fragments_rebuild_the_table(bf16):
    """The mma path's table: the B-fragment order inverts to the rows, and
    an f32 table's three bf16 pieces sum to it exactly, so a one-hot product
    over them is an exact row fetch."""
    tab, _ = onehot_probe.case_inputs('pallas_probe_onehot.py:63', 64, 1, 1)
    t = torch.as_tensor(tab)
    table = onehot_probe.Table(t, bf16)
    f = table.frag.float()
    pieces, _, kt, _, _ = f.shape
    # [piece, strip, kt, g, t, h, j] -> [piece, kt, h, t, j, strip, g]
    rows = f.reshape(pieces, 16, kt, 8, 4, 2, 2).permute(
        0, 2, 5, 4, 6, 1, 3).reshape(pieces, kt * 16, 128)
    got = rows[0] if pieces == 1 else (rows[0] + rows[1]) + rows[2]
    want = t.to(torch.bfloat16).float() if bf16 else t
    assert pieces == (1 if bf16 else 3)
    assert torch.equal(got, want)


@pytest.mark.parametrize('mod', [gather_probe, bf16_probe, step_probe,
                                 onehot_probe],
                         ids=lambda m: m.__name__.rsplit('.', 1)[1])
def test_probe_main_runs_plain_on_cpu(mod, capsys):
    assert mod.main(['--device', 'cpu']) == 0
    assert 'ok=True' in capsys.readouterr().out
