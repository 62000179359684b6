"""The port's guiding sums and EMA against the JAX package: the plain
segmented sum against ``segment_sum_pairs`` (Pallas, interpret mode) and
``jax.ops.segment_sum`` at rtol 1e-5 (the summation order differs), and
``accumulate_buckets`` / ``propagate`` against the JAX versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pathtracer_tpu.models import guiding as jg
from cuda_pathtracer_tpu.ops.guiding_scatter import segment_sum_pairs as jssp
from cuda_pathtracer_tpu_torch.models import guiding as tg
from cuda_pathtracer_tpu_torch.ops import guiding_scatter as tgs
from cuda_pathtracer_tpu_torch.ops import kernels


def _updates(L, n_bins, seed, dist='mixed'):
    """(energy, weight, seg): 60% of the updates kept on random bins
    ('mixed'), none kept ('discard') or all on bin 0 ('one bin')."""
    rng = np.random.default_rng(seed)
    valid = rng.random(L) < {'mixed': 0.6, 'discard': 0.0, 'one bin': 1.0}[dist]
    ids = rng.integers(0, n_bins, L) if dist == 'mixed' else np.zeros(L, int)
    seg = np.where(valid, ids, n_bins).astype(np.int32)
    e = np.where(valid, rng.random(L) * 100, 0.0).astype(np.float32)
    w = valid.astype(np.float32)
    return e, w, seg


@pytest.mark.parametrize('L,n_bins,seed,dist', [
    pytest.param(L, n_bins, seed, dist, id=f'{L}-{n_bins}-{seed}'
                 + ('' if dist == 'mixed' else f'-{dist}'))
    for L, n_bins, seed, dist in (
        (3000, 4096, 0, 'mixed'), (6144, 16000, 1, 'mixed'),
        (700, 24, 2, 'mixed'), (2050, 512, 6, 'discard'),
        (1500, 1, 7, 'one bin'), (1027, 300, 8, 'one bin'))])
def test_segment_sum_matches_jax(L, n_bins, seed, dist):
    e, w, seg = _updates(L, n_bins, seed, dist)
    ge, gw = tgs.segment_sum_pairs(torch.as_tensor(e), torch.as_tensor(w),
                                   torch.as_tensor(seg), n_bins)
    pe, pw = jssp(jnp.asarray(e), jnp.asarray(w), jnp.asarray(seg),
                  num_segments=n_bins + 1, interpret=True)
    both = jax.ops.segment_sum(jnp.stack([jnp.asarray(e), jnp.asarray(w)], -1),
                               jnp.asarray(seg), num_segments=n_bins + 1)
    for got, want in ((ge, pe), (gw, pw), (ge, both[:, 0]), (gw, both[:, 1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:-1],
                                   rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu_only():
    e, w, seg = _updates(100, 64, 3)
    before = dict(kernels.LAUNCHES)
    tgs.segment_sum_pairs(torch.as_tensor(e), torch.as_tensor(w),
                          torch.as_tensor(seg), 64)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError):
        tgs.segment_sum_pairs(torch.empty(4, device='meta'),
                              torch.empty(4, device='meta'),
                              torch.empty(4, dtype=torch.int32, device='meta'), 8)


def _sample_cache(n_tris, B, seed):
    rng = np.random.default_rng(seed)
    stype = rng.choice([0, 1, 2], size=(3, B), p=[0.2, 0.2, 0.6]).astype(np.int32)
    tri = rng.integers(0, n_tris, (3, B)).astype(np.int32)
    bucket = rng.integers(0, 8, (3, B)).astype(np.int32)
    cum = rng.random((3, B, 3)).astype(np.float32) + 0.05
    cum[0, :5, 1] = 0.0    # exact-zero channels: fmin keeps the NaN out
    energy = (rng.random((B, 3)) * 4).astype(np.float32)
    return stype, tri, bucket, cum, energy


def test_accumulate_buckets_matches_jax():
    n_tris, B = 50, 900
    stype, tri, bucket, cum, energy = _sample_cache(n_tris, B, 4)
    js, jw = jg.accumulate_buckets(
        n_tris, jg.SampleCache(*map(jnp.asarray, (stype, tri, bucket, cum))),
        jnp.asarray(energy))
    ts_, tw = tg.accumulate_buckets(
        n_tris, tg.SampleCache(*map(torch.as_tensor, (stype, tri, bucket, cum))),
        torch.as_tensor(energy))
    assert np.isfinite(ts_.numpy()).all()
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize('enabled', [True, False])
def test_propagate_matches_jax(enabled):
    n_tris = 60
    rng = np.random.default_rng(5)
    cache = (rng.random((n_tris, 8)) * 1.5 + 0.1).astype(np.float32)
    total = cache.sum(1).astype(np.float32)
    add_sum = (rng.random((n_tris, 8)) * 30).astype(np.float32)
    add_cnt = rng.integers(0, 4, (n_tris, 8)).astype(np.float32)
    want = jg.propagate(jg.RadianceState(jnp.asarray(cache), jnp.asarray(total)),
                        jnp.asarray(add_sum), jnp.asarray(add_cnt),
                        jnp.asarray(enabled))
    got = tg.propagate(tg.RadianceState(torch.as_tensor(cache),
                                        torch.as_tensor(total)),
                       torch.as_tensor(add_sum), torch.as_tensor(add_cnt),
                       enabled)
    np.testing.assert_array_equal(got.cache.numpy(), np.asarray(want.cache))
    np.testing.assert_allclose(got.total.numpy(), np.asarray(want.total),
                               rtol=1e-6)
