"""Device-side scene representation (counterpart of
``cuda_pathtracer_tpu/scene/device.py``; the reference's SceneBuffers,
src/types.h:689-703, plus its __constant__ lights, skydome and blue noise).

  * SceneArrays   — static for a scene's lifetime
  * DynamicArrays — instances, emissive lights, the world triangles and the
    world BVH tables, rebuilt or refitted when the scene is invalidated

Left out against the JAX package, because they worked around TPU gather
costs or Mosaic limits or fed its XLA traversals: ``sky_pairs``, the atlas
texel pairs, ``nmap_marker``, the float-valued ids and baked attributes of
``tri_meta`` (ids are int32 here, ``tri_gid`` / ``tri_inst``; its world
vertices are ``world_tris``), ``tri_blocks``, the threaded and wide world
tables and the coherence-sort ``bounds``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .textures import TextureStack


class SceneArrays(NamedTuple):
    # triangle attributes, global model-space order (TriangleD, types.h:85-96)
    tri_normal: torch.Tensor      # f32[T, 3]
    tri_tangent: torch.Tensor     # f32[T, 3]
    tri_bitangent: torch.Tensor   # f32[T, 3]
    tri_uv: torch.Tensor          # f32[T, 6] uv0|uv1|uv2
    tri_mat: torch.Tensor         # i32[T]

    # material table (Material, types.h:33-56)
    mat_diffuse: torch.Tensor     # f32[M, 3]
    mat_specular: torch.Tensor    # f32[M, 3]
    mat_emission: torch.Tensor    # f32[M, 3]
    mat_reflect: torch.Tensor     # f32[M]
    mat_glossy: torch.Tensor      # f32[M]
    mat_transmit: torch.Tensor    # f32[M]
    mat_ior: torch.Tensor         # f32[M]
    mat_absorption: torch.Tensor  # f32[M, 3]
    mat_tex: torch.Tensor         # i32[M]  (-1 = none)
    mat_normal_tex: torch.Tensor  # i32[M]  (-1 = none)

    textures: TextureStack

    # analytic primitives
    sphere_pos: torch.Tensor      # f32[S, 3]
    sphere_radius: torch.Tensor   # f32[S]
    sphere_mat: torch.Tensor      # i32[S]
    plane_normal: torch.Tensor    # f32[P, 3]
    plane_d: torch.Tensor         # f32[P]
    plane_mat: torch.Tensor       # i32[P]

    # lights
    point_light_pos: torch.Tensor    # f32[L, 3]
    point_light_color: torch.Tensor  # f32[L, 3]
    light_tri: torch.Tensor          # i32[TL] global triangle id (emissive)
    light_inst: torch.Tensor         # i32[TL] owning instance

    # environment
    sky_img: torch.Tensor         # f32[Hs, Ws, 3] equirect, bottom-row-first
    blue_noise: torch.Tensor      # f32[Hb, Wb]

    # one-row-per-lookup tables; the int fields (material, texture ids) are
    # int32 bit patterns stored in the f32 row and read back with
    # .view(torch.int32), never through float arithmetic
    mat_packed: torch.Tensor      # f32[M, 24]: diffuse|specular|emission|
                                  #   reflect|glossy|transmit|ior|absorption|
                                  #   tex(bits)|ntex(bits)
    tri_packed: torch.Tensor      # f32[T, 16]: normal|tangent|bitangent|uv6|
                                  #   mat(bits)
    sphere_packed: torch.Tensor   # f32[S, 8]: pos|radius|mat(bits)
    plane_packed: torch.Tensor    # f32[P, 8]: normal|d|mat(bits)


class DynamicArrays(NamedTuple):
    inst_transform: torch.Tensor    # f32[I, 3, 4]
    inst_inv: torch.Tensor          # f32[I, 3, 4]
    inst_mat: torch.Tensor          # i32[I] material override (-1 = none)
    # world-space emissive light triangles (NEE, kernels.h:672-752)
    light_v0w: torch.Tensor         # f32[TL, 3]
    light_v1w: torch.Tensor         # f32[TL, 3]
    light_v2w: torch.Tensor         # f32[TL, 3]
    light_normal_w: torch.Tensor    # f32[TL, 3]
    light_emission_w: torch.Tensor  # f32[TL, 3]
    light_packed: torch.Tensor      # f32[TL, 16]: v0|v1|v2|normal|emission
    inst_packed: torch.Tensor       # f32[I, 16]: transform(12)|override(bits)
    # world triangle (the traversal's prim_id) -> model-space triangle id
    # and owning instance
    tri_gid: torch.Tensor           # i32[WT]
    tri_inst: torch.Tensor          # i32[WT]
    # world-space vertices v0|v1|v2 of each world triangle, in prim_id
    # order: shading re-intersects the winning triangle from these when the
    # trace returns no barycentrics (the v1 traversal)
    world_tris: torch.Tensor        # f32[WT, 9]
    # the split v1 packet tables (ops/traverse_packet.py), refitted on the
    # device for animated frames (accel/refit.py)
    packet_inner: torch.Tensor      # f32[Ni, 128]
    packet_leaf: torch.Tensor       # f32[Nl, 128]
    # merged contiguous-children 16-ary world BVH, the v2 traversal's table
    # (ops/traverse_packet2.py); [0, 128] past its 2^20-row ceiling
    packet_merged: torch.Tensor     # f32[NM, 128]
    depth: int                      # max depth of the wide tree
