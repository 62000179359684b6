"""Helpers shared by the port's Whitted-mode tests.

``jax_frames(scene, camera, clears)`` renders frames with the JAX
``Raytracer`` (jitted, as the package runs it) and reads the active lanes of
each recursion level through a debug callback in a wrapped ``_shade_level``;
the jit cache is dropped around the call, so the wrapper is traced in and
then out again.

``count_traversals(monkeypatch)`` counts the port's plain traversal calls by
route (``v1``, ``v2``), to show which of them a CPU run went through.

``agree(got, want)`` is the share of pixels within 1e-3 relative + 1e-5
absolute, the tolerance of every Whitted comparison.
"""
import jax
import numpy as np
import pytest

from cuda_pathtracer_tpu.models import raytracer as jrt
from cuda_pathtracer_tpu_torch.ops import traverse_packet as tp1
from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as tp2


def jax_frames(scene, camera, clears, width, height):
    """Render one JAX Whitted frame per entry of ``clears`` (the
    ``should_clear`` flag) on one Raytracer. Returns [(frame f32[H*W, 3],
    active lanes per level)]."""
    orig = jrt._shade_level
    counts = {}

    def shade_level(*args, **kw):
        level = len(counts)
        counts[level] = None
        jax.debug.callback(
            lambda n, _l=level: counts.__setitem__(_l, int(n)),
            args[6].sum())
        return orig(*args, **kw)

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrt, '_shade_level', shade_level)
        jrt.render_whitted.clear_cache()
        try:
            rt = jrt.Raytracer(scene, width, height)
            for clear in clears:
                counts.clear()
                rt.render(camera, should_clear=clear)
                rt.finish()
                jax.effects_barrier()
                active = [counts[i] for i in range(len(counts))]
                assert None not in active, active
                out.append((np.asarray(rt.frame), active))
        finally:
            jrt.render_whitted.clear_cache()
    return out


def count_traversals(monkeypatch) -> dict:
    calls = {'v1': 0, 'v2': 0}
    for mod, name, key in ((tp1, 'traverse_packet_ref', 'v1'),
                           (tp2, 'traverse_merged_ref', 'v2')):
        def counted(*a, _f=getattr(mod, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


def agree(got, want) -> float:
    return float(np.isclose(got, want, rtol=1e-3, atol=1e-5).all(
        axis=-1).mean())
