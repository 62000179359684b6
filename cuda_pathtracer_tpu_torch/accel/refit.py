"""Per-frame refit of the world tables on the scene's device (counterpart of
``cuda_pathtracer_tpu/accel/refit.py``).

The reference refreshes only the instance matrices and the small top-level
BVH per invalidation (src/pathtracer.h:245-246, src/scene.h:400); the
bottom BVHs never leave the device. Here the spliced tables are built once
in model space (identity transforms) as templates on the device, and every
move-only invalidation transforms them with tensor ops instead of
re-baking every world triangle on the host and uploading tens of MB.

What moves per invalidation: the instance transforms (I x 12 floats) and the
few TOP rows of the instance grouping, rebuilt on the host from the
transformed instance root boxes as the reference's per-frame
BuildTopLevelBVH does. Splice topology (refs, triangle ids, world-triangle
numbering) is frozen when the templates are built.

Ported: the v1 packet tables (``packet_inner``, ``packet_leaf``), from which
the v2 merged table is re-derived (``ops/traverse_packet2.py::
derive_merged``), and the world triangles. The JAX package's unified wide
table and threaded node boxes feed its XLA traversals, which the port does
not have, and are not refitted.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .wide import ARITY, LEAF_MAX, build_world_wide
from ..ops.traverse_packet import split_packet_tables

# 8 box corners as min/max selectors
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                     [1, 1, 1], [0, 1, 1], [1, 0, 1], [1, 1, 0]], np.float32)


class RefitTemplates(NamedTuple):
    """Model-space spliced tables and per-row owners (built once per scene
    topology), on the scene's device."""
    inner: torch.Tensor       # f32[Ni, 128] v1 inner table, model space
    leaf: torch.Tensor        # f32[Nl, 128] v1 leaf table, model space
    inner_inst: torch.Tensor  # i64[Ni] owning instance; -1 = top row
    leaf_inst: torch.Tensor   # i64[Nl]
    n_top: int                # leading inner rows rebuilt on the host
    top: np.ndarray           # f32[n_top, 128] those rows' template, host
    tris: torch.Tensor        # f32[WT, 9] v0|v1|v2, model space
    tri_inst: torch.Tensor    # i64[WT]


def _n_top(n_inst: int) -> int:
    """Rows of the instance grouping above the instance roots."""
    n_top = 0
    cnt = n_inst
    while cnt > 1:
        n_top += (cnt + ARITY - 1) // ARITY
        cnt = (cnt + ARITY - 1) // ARITY
    return n_top


def _gather_tf(t34, inst):
    """t34: f32[I+1, 3, 4], its last row the identity for inst == -1."""
    idx = torch.where(inst < 0, torch.full_like(inst, t34.shape[0] - 1), inst)
    tf = t34[idx]                               # [R, 3, 4]
    return tf[:, :, :3], tf[:, :, 3]


def _refit_packet_inner(inner, inner_inst, t34, top_rows):
    rot, trn = _gather_tf(t34, inner_inst)
    box = inner[:, :96].reshape(-1, 6, ARITY)
    vmin = box[:, 0:3].transpose(1, 2)          # [R, 16, 3]
    vmax = box[:, 3:6].transpose(1, 2)
    sel = torch.as_tensor(_CORNERS, device=inner.device)
    corners = (vmin[:, :, None, :] * (1 - sel)
               + vmax[:, :, None, :] * sel)     # [R, 16, 8, 3]
    wc = torch.einsum('rij,rcgj->rcgi', rot, corners) + trn[:, None, None, :]
    # amin/amax propagate NaN: empty slots stay NaN
    nmin = wc.amin(dim=2)
    nmax = wc.amax(dim=2)
    nb = torch.cat([nmin.transpose(1, 2), nmax.transpose(1, 2)],
                   dim=1).reshape(-1, 96)
    out = torch.cat([nb, inner[:, 96:]], dim=1)
    if top_rows.shape[0]:
        out[:top_rows.shape[0]] = top_rows
    return out


def _refit_packet_leaf(leaf, leaf_inst, t34):
    rot, trn = _gather_tf(t34, leaf_inst)
    tr = leaf[:, :9 * LEAF_MAX].reshape(-1, 3, 3, LEAF_MAX)  # [R, (v0,e1,e2), xyz, 12]
    w = torch.einsum('rij,rvjt->rvit', rot, tr)
    # v0 gets the translation; e1 and e2 are directions
    w[:, 0] += trn[:, :, None]
    return torch.cat([w.reshape(-1, 9 * LEAF_MAX), leaf[:, 9 * LEAF_MAX:]],
                     dim=1)


def _refit_tris(tris, tri_inst, t34):
    rot, trn = _gather_tf(t34, tri_inst)
    tv = tris.reshape(-1, 3, 3)
    wt = torch.einsum('rij,rvj->rvi', rot, tv) + trn[:, None, :]
    return wt.reshape(-1, 9)


def top_row_boxes(inst_boxes: np.ndarray):
    """Host-side rebuild of the TOP rows' child boxes: the grouping loop of
    ``accel/wide.py::build_world_wide`` (chunks of ARITY in instance order,
    parents placed from the back of the reserved region). inst_boxes:
    f32[I, 6] world boxes of the instance roots.

    Returns (boxes f32[n_top, 6, ARITY] with +-inf sentinels in empty slots,
    valid bool[n_top, ARITY]) in top-row order; n_top == 0 for one instance.
    """
    n_inst = len(inst_boxes)
    n_top = _n_top(n_inst)
    if n_top == 0:
        return (np.zeros((0, 6, ARITY), np.float32),
                np.zeros((0, ARITY), bool))

    boxes = np.zeros((n_top, 6, ARITY), np.float32)
    boxes[:, 0:3] = 3.0e38
    boxes[:, 3:6] = -3.0e38
    valid = np.zeros((n_top, ARITY), bool)
    level = [inst_boxes[i] for i in range(n_inst)]
    next_free = n_top
    while len(level) > 1:
        nxt = []
        for g in range(0, len(level), ARITY):
            chunk = level[g:g + ARITY]
            next_free -= 1
            for k, b in enumerate(chunk):
                boxes[next_free, 0:3, k] = b[0:3]
                boxes[next_free, 3:6, k] = b[3:6]
                valid[next_free, k] = True
            gmin = np.min([b[0:3] for b in chunk], axis=0)
            gmax = np.max([b[3:6] for b in chunk], axis=0)
            nxt.append(np.concatenate([gmin, gmax]))
        level = nxt
    assert next_free == 0
    return boxes, valid


def patch_top_rows(template_rows: np.ndarray, boxes: np.ndarray,
                   valid: np.ndarray, box_offset: int,
                   empty_min: float, empty_max: float):
    """New top rows = template rows (static refs) with fresh child boxes.
    Empty slots get (empty_min, empty_max): NaN/NaN in the packet layout."""
    n_top = len(boxes)
    rows = np.array(template_rows[:n_top], copy=True)
    fill = np.array([empty_min] * 3 + [empty_max] * 3,
                    np.float32)[None, :, None]
    b = np.where(valid[:, None, :], boxes, fill)
    rows[:, box_offset:box_offset + 6 * ARITY] = b.reshape(n_top, -1)
    return rows


def build_templates(model_wides, inst_model, wtri_bases, wb,
                    tri_v0, tri_v1, tri_v2, depth: int,
                    device) -> RefitTemplates:
    """Capture the model-space spliced tables once per scene topology.

    The splice order does not depend on the transforms (instances in order,
    ARITY-chunked top grouping), so building with identity transforms gives
    the live tables' refs and ids with model-space geometry. ``wb`` is the
    full build's world BVH: its world-triangle numbering is frozen here."""
    n_inst = len(inst_model)
    ident = np.tile(np.hstack([np.eye(3, dtype=np.float32),
                               np.zeros((3, 1), np.float32)]),
                    (n_inst, 1, 1))
    ww = build_world_wide(model_wides, inst_model, ident, wtri_bases)

    # per-row owner: n_top leading rows are -1, then one block per instance
    n_top = _n_top(n_inst)
    wide_inst = np.full(len(ww.rows), -1, np.int64)
    pos = n_top
    for i in range(n_inst):
        n = len(model_wides[inst_model[i]].rows)
        wide_inst[pos:pos + n] = i
        pos += n
    assert pos == len(ww.rows)

    ptab = split_packet_tables(ww.rows, depth)
    tag = ww.rows[:, 0]
    inner_inst = wide_inst[tag > 0]
    leaf_inst = wide_inst[tag < 0]
    # split_packet_tables synthesizes an always-hit root (or an empty leaf
    # table) when a side is missing; those rows do not move
    if len(inner_inst) != len(ptab.inner):
        inner_inst = np.full(len(ptab.inner), -1, np.int64)
    if len(leaf_inst) != len(ptab.leaf):
        leaf_inst = np.full(len(ptab.leaf), -1, np.int64)

    tris_model = np.concatenate(
        [tri_v0[wb.tri_gid], tri_v1[wb.tri_gid], tri_v2[wb.tri_gid]],
        axis=1).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return RefitTemplates(
        inner=t(ptab.inner), leaf=t(ptab.leaf),
        inner_inst=t(inner_inst), leaf_inst=t(leaf_inst), n_top=n_top,
        top=ptab.inner[:n_top].copy(),
        tris=t(tris_model), tri_inst=t(wb.tri_inst.astype(np.int64)))


def refit_all(templates: RefitTemplates, transforms: np.ndarray,
              inst_root_boxes: np.ndarray):
    """One invalidation: the host rebuilds the top rows, the device
    transforms everything else. Returns (packet_inner, packet_leaf,
    world_tris) on the templates' device."""
    dev = templates.inner.device
    ident = np.hstack([np.eye(3, dtype=np.float32),
                       np.zeros((3, 1), np.float32)])
    t34 = torch.as_tensor(np.concatenate(
        [transforms.astype(np.float32), ident[None]], axis=0), device=dev)

    n_top = templates.n_top
    if n_top:
        boxes, valid = top_row_boxes(inst_root_boxes)
        top = patch_top_rows(templates.top, boxes, valid, 0, np.nan, np.nan)
    else:
        top = np.zeros((0, 128), np.float32)
    inner = _refit_packet_inner(templates.inner, templates.inner_inst, t34,
                                torch.as_tensor(top, device=dev))
    leaf = _refit_packet_leaf(templates.leaf, templates.leaf_inst, t34)
    tris = _refit_tris(templates.tris, templates.tri_inst, t34)
    return inner, leaf, tris
