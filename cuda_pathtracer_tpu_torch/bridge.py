"""JAX-package state -> the port's tensors (the port's "weights" loader).

Takes the JAX package's ``SceneArrays``, ``DynamicArrays``, ``RadianceState``
and ``Camera`` with every leaf already a numpy array (the caller applies
``np.asarray`` to each leaf, e.g. ``jax.tree.map(np.asarray, x)``) and returns
the port's NamedTuples on ``device``. Fields the port dropped (``sky_pairs``,
``nmap_marker``, the atlas texel pairs, ``tri_meta``, ``tri_blocks``, the
wide and threaded tables, ``bounds``) are not read. Imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.camera import Camera
from .models.guiding import RadianceState
from .scene.device import SceneArrays, DynamicArrays
from .scene.textures import TextureStack


def _t(a, device):
    return torch.from_numpy(np.array(a)).to(device)


def scene_arrays(sa, device) -> SceneArrays:
    tex = sa.textures
    fields = {f: _t(getattr(sa, f), device)
              for f in SceneArrays._fields if f != 'textures'}
    return SceneArrays(textures=TextureStack(
        _t(tex.texels, device), _t(tex.offset, device), _t(tex.width, device),
        _t(tex.height, device)), **fields)


def dynamic_arrays(dy, depth: int, device) -> DynamicArrays:
    """``depth`` is the merged tree's depth (the JAX scene's
    ``wide_depth``), which the JAX DynamicArrays does not carry."""
    fields = {f: _t(getattr(dy, f), device) for f in DynamicArrays._fields
              if f not in ('tri_gid', 'tri_inst', 'world_tris', 'depth')}
    return DynamicArrays(tri_gid=_t(dy.world.tri_gid, device),
                         tri_inst=_t(dy.world.tri_inst, device),
                         world_tris=_t(dy.world.tris, device),
                         depth=int(depth), **fields)


def radiance_state(rs, device) -> RadianceState:
    return RadianceState(_t(rs.cache, device), _t(rs.total, device))


def camera(cam, device) -> Camera:
    return Camera(*(_t(np.asarray(x, np.float32), device) for x in cam))
