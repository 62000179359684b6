"""The renderer's one trace entry point (counterpart of
``cuda_pathtracer_tpu/ops/dispatch.py::trace``): the sphere/plane prepass,
then one of the two BVH traversals, each of which launches its CUDA kernel
on the card and runs its plain version on the CPU:

  * v2, the merged table (``ops/traverse_packet2.py``), with barycentrics:
    the default whenever the scene has a merged table of more than one row;
  * v1, the split inner/leaf tables (``ops/traverse_packet.py``), without
    barycentrics: when ``PACKET_V1`` is set (``CPT_PACKET_V1=1``, read at
    import), or when the scene is past the merged table's 2^20-row ceiling.

Both give exact ``t`` on any table size; neither has a row cap below that
ceiling. ``2mtris`` (303,709 merged rows, 155.5 MB: past the card's L2)
runs on v2 from HBM, where the JAX package splits its table between VMEM
and an HBM DMA walk; under ``PACKET_V1`` it runs on v1's split tables
(23,028 inner + 280,681 leaf rows), where the JAX package, past its v1's
``PACKET_MAX_ROWS`` of 180,000, walks ``traverse_wide`` instead. The
kernels index rows in ``size_t`` and carry depth 8 well inside their
stacks (48 and 64 entries).
"""
from __future__ import annotations

import os

from .traverse import Hit, prepass
from .traverse_packet import PacketTables, traverse_packet
from .traverse_packet2 import MergedTable, traverse_merged

PACKET_V1 = bool(int(os.environ.get('CPT_PACKET_V1', '0')))


def use_packet2(dyn) -> bool:
    return not PACKET_V1 and int(dyn.packet_merged.shape[0]) > 1


def trace(scene, dyn, ro, rd, *, t_max=None, active=None,
          any_hit: bool = False, stop_on_hit=None,
          want_uv: bool = False) -> Hit:
    """Closest-hit (or any-hit) trace of ro/rd f32[B, 3].

    t_max: f32[B] ray length cap; active: bool[B] lanes that carry a ray;
    stop_on_hit: bool[B] lanes that end at their first hit (default: all
    when ``any_hit``). ``want_uv`` asks for the winning triangle's
    barycentrics in Hit.u / Hit.v (closest-hit only); only v2 gives them,
    v1 returns ``u = v = None``.

    On v2 a trace on the card is two launches of ``csrc/traverse.cu``: the
    sphere/plane prepass (which fills in the defaults), then the walk with
    its merge epilogue, called through this module's ``traverse_merged``
    with the prepass's t0, live and stop."""
    # the one place a trace's rays are made contiguous, as the kernels'
    # wrappers require (a no-op on rays that are)
    ro, rd, t_max, active, stop_on_hit = (
        x.contiguous() if x is not None else None
        for x in (ro, rd, t_max, active, stop_on_hit))
    if not use_packet2(dyn):
        return traverse_packet(
            scene, PacketTables(dyn.packet_inner, dyn.packet_leaf, dyn.depth),
            ro, rd, t_max=t_max, active=active, any_hit=any_hit,
            stop_on_hit=stop_on_hit)
    pre = prepass(scene, ro, rd, t_max=t_max, active=active,
                  stop_on_hit=stop_on_hit, any_hit=any_hit)
    return traverse_merged(
        MergedTable(dyn.packet_merged, dyn.depth), ro, rd, pre.t, pre.live,
        pre.stop, want_uv=want_uv and not any_hit, prepass=pre, active=active)
