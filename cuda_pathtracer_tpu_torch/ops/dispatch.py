"""The renderer's one trace entry point (counterpart of
``cuda_pathtracer_tpu/ops/dispatch.py::trace``): the sphere/plane prepass,
then one of the two BVH traversals, each of which launches its CUDA kernel
on the card and runs its plain version on the CPU:

  * v2, the merged table (``ops/traverse_packet2.py``), with barycentrics:
    the default whenever the scene has a merged table of more than one row;
  * v1, the split inner/leaf tables (``ops/traverse_packet.py``), without
    barycentrics: when ``PACKET_V1`` is set (``CPT_PACKET_V1=1``, read at
    import), or when the scene is past the merged table's 2^20-row ceiling.
"""
from __future__ import annotations

import os

import torch

from .traverse import Hit, PRIM_TRIANGLE, _primitives_prepass
from .traverse_packet import PacketTables, traverse_packet
from .traverse_packet2 import MergedTable, traverse_merged
from ..constants import T_MAX

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
    v1 returns ``u = v = None``."""
    B = ro.shape[0]
    dev = ro.device
    if t_max is None:
        t_max = torch.full((B,), T_MAX, dtype=torch.float32, device=dev)
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=dev)
    if stop_on_hit is None:
        stop_on_hit = torch.full((B,), bool(any_hit), device=dev)
    if not use_packet2(dyn):
        return traverse_packet(
            scene, PacketTables(dyn.packet_inner, dyn.packet_leaf, dyn.depth),
            ro, rd, t_max=t_max, active=active, any_hit=any_hit,
            stop_on_hit=stop_on_hit)
    t0, ptype0, pid0, found0 = _primitives_prepass(scene, ro, rd, t_max)
    # a stop-on-hit lane whose prepass already found an occluder is done
    live = active & ~(stop_on_hit & found0)
    want_uv = want_uv and not any_hit
    t, gid, found, u, v = traverse_merged(
        MergedTable(dyn.packet_merged, dyn.depth), ro.contiguous(),
        rd.contiguous(), t0.contiguous(), live, stop_on_hit.contiguous(),
        want_uv=want_uv)
    ptype = torch.where(found, torch.full_like(ptype0, PRIM_TRIANGLE), ptype0)
    pid = torch.where(found, gid, pid0)
    intersected = active & (found | found0)
    if want_uv:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        u = torch.where(found, u, zero)
        v = torch.where(found, v, zero)
    return Hit(t=t, prim_type=ptype, prim_id=pid, intersected=intersected,
               u=u, v=v)
