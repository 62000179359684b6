"""The lanes of each Whitted recursion level on the card, formed by
``csrc/whitted_lanes.cu`` (``models/raytracer.py::render_whitted`` calls
them).

:func:`primary_rays` writes level 0's lanes in one launch; :func:`compact`
packs a level's children into the next level's lanes in two launches, one
read-back of the count and, on a level cut by weight, the sort. Each gives
its plain version's result bit for bit: ``raytracer._rays_plain``
(``camera.generate_rays_simple``, the frame's zeroed sums) and
``raytracer._compact``, which are the CPU route and the kernels' reference
on the card.

A compaction of ``ordered`` lanes sorts one unique 64-bit key a lane
(falling ``max_comp`` of weight, then lane index). Up to
:func:`sort_threshold` keys a block sorts them in registers and shared
memory and gathers kept lanes in the same launch (``block``; every block
sorts the same keys and gathers its ``GATHER_ROWS`` of them); above it
``torch.sort`` sorts them and a kernel gathers (``library``).

The wrappers take CUDA tensors only (or raise). Each launch adds one to
``kernels.LAUNCHES['whitted_lanes']``, and each ordered compaction one to
``LAUNCHES['whitted_sort_block']`` or ``['whitted_sort_library']``.
"""
from __future__ import annotations

import torch

from . import kernels
from ..core import vecmath as vm
from ..utils.profiling import span

_F32, _I64, _BOOL = torch.float32, torch.int64, torch.bool

# lanes each block of the block sort gathers, after sorting all the
# keys: the scattered loads of the gather then spread over the SMs
GATHER_ROWS = 512

_capacity = {}
_pinned = {}


def _launched(err: int):
    kernels.LAUNCHES['whitted_lanes'] += 1
    kernels.check(err, 'whitted_lanes')


def _check(tensors, dtypes, shapes):
    """The wrappers' contract: each tensor of its dtype and shape (checked
    first, so on any device), then all on one CUDA device and contiguous."""
    for i, (t, dtype, shape) in enumerate(zip(tensors, dtypes, shapes)):
        if t.dtype != dtype:
            raise TypeError(f'whitted_lanes: argument {i} is {t.dtype}, '
                            f'expected {dtype}')
        if tuple(t.shape) != shape:
            raise ValueError(f'whitted_lanes: argument {i} has shape '
                             f'{tuple(t.shape)}, expected {shape}')
    kernels.require_cuda('whitted_lanes', *tensors)


def sort_threshold(device) -> int:
    """The most keys a compaction on ``device`` sorts in a block: the
    largest power of two that a block's threads hold (8 keys a thread) and
    whose keys fit the card's shared memory for a block. Up to it the block
    sort's device time stayed below the library sort's on an H100 (52.6
    against 86.2 us for 8,192 keys: ``chip_smoke.py``'s ``sweep_sorts``,
    PERF.md section 6), so no crossover lowers it."""
    device = torch.device(device)
    if device not in _capacity:
        with torch.cuda.device(device):
            _capacity[device] = kernels.library().cpt_whitted_sort_capacity()
    return _capacity[device]


def primary_rays(camera, width: int, height: int, max_depth: int):
    """Level 0 of a ``width`` x ``height`` frame from ``camera``
    (``core/camera.py::Camera`` on the card): (origin, direction, weight
    f32[B, 3], pixel i64[B], the frame f32[B, 3] and the levels' shadow-ray
    counts i64[max_depth], both zeroed), as ``raytracer._rays_plain``."""
    eye, view, d = camera.eye, camera.view_dir, camera.d
    _check((eye, view, d), (_F32,) * 3, ((3,), (3,), ()))
    if width <= 0 or height <= 0 or max_depth < 0 or \
            width * height > 2 ** 31 - 1:
        raise ValueError(f'whitted_lanes: no frame of {width}x{height} '
                         f'at depth {max_depth}')
    B, dev = width * height, eye.device
    ro, rd, weight, pixel = _lanes(B, dev)
    out = torch.empty((B, 3), dtype=_F32, device=dev)
    shadow = torch.empty(max_depth, dtype=_I64, device=dev)
    ar = width / height
    _launched(kernels.library().cpt_whitted_primary_rays(
        eye.data_ptr(), view.data_ptr(), d.data_ptr(), width, height, ar,
        2.0 * ar, max_depth, ro.data_ptr(), rd.data_ptr(), weight.data_ptr(),
        pixel.data_ptr(), out.data_ptr(), shadow.data_ptr(),
        kernels.stream_of(eye)))
    return ro, rd, weight, pixel, out, shadow


def _read_count(count, stream) -> int:
    """The device's i32 ``count``, through pinned host memory (span
    ``sync.compact``: the compaction's one wait for the card)."""
    host = _pinned.get(count.device)
    if host is None:
        host = _pinned[count.device] = torch.empty(1, dtype=torch.int32,
                                                   pin_memory=True)
    with span('sync.compact'):
        kernels.check(kernels.library().cpt_whitted_lanes_read_count(
            count.data_ptr(), host.data_ptr(), stream), 'whitted_lanes')
    return host.item()


def compact(ro, rd, w, pixel, active, cap: int, ordered: bool):
    """``raytracer._compact`` on the card: the ``active`` lanes of (origin,
    direction, weight f32[m, 3], pixel i64[m]) in their order, or, when
    ``ordered``, in falling ``max_comp`` of weight (ties in lane order) cut
    to ``cap``. Returns ((ro, rd, w, pixel), active lanes dropped, the sort
    path: ``none``, ``block`` or ``library``)."""
    m = active.shape[0] if active.dim() else -1
    _check((ro, rd, w, pixel, active), (_F32, _F32, _F32, _I64, _BOOL),
           ((m, 3),) * 3 + ((m,),) * 2)
    if cap < 0 or m > 2 ** 31 - 1:
        raise ValueError(f'whitted_lanes: cap {cap} or {m} lanes out of '
                         f'range')
    if not m:
        return (ro, rd, w, pixel), 0, 'none'
    count, packed = scan(ro, rd, w, pixel, active, ordered)
    n = _read_count(count, kernels.stream_of(ro))
    dropped, kept = max(n - cap, 0), min(n, cap)
    if not ordered:
        return tuple(a[:n] for a in packed), dropped, 'none'
    if not kept:
        return _lanes(0, ro.device), dropped, 'none'
    path = 'block' if n <= sort_threshold(ro.device) else 'library'
    return sorted_lanes(packed, n, kept, (ro, rd, w, pixel), path), \
        dropped, path


def scan(ro, rd, w, pixel, active, ordered: bool):
    """The compaction's two launches on m > 0 lanes checked by
    :func:`compact`: (the count of active lanes, an i32[1] on the card;
    the active lanes packed into m-row buffers, or when ``ordered`` their
    keys i64[m], in their first rows)."""
    m, dev = active.shape[0], ro.device
    lib, stream = kernels.library(), kernels.stream_of(ro)
    tiles = lib.cpt_whitted_lanes_tiles(m)
    scratch = torch.empty(tiles + 1, dtype=torch.int32, device=dev)
    _launched(lib.cpt_whitted_lanes_count(active.data_ptr(), m,
                                          scratch.data_ptr(), stream))
    if ordered:
        packed = torch.empty(m, dtype=_I64, device=dev)
        ptrs = (None,) * 4 + (packed.data_ptr(),)
    else:
        packed = _lanes(m, dev)
        ptrs = tuple(a.data_ptr() for a in packed) + (None,)
    _launched(lib.cpt_whitted_lanes_scatter(
        active.data_ptr(), m, scratch.data_ptr(), ro.data_ptr(),
        rd.data_ptr(), w.data_ptr(), pixel.data_ptr(), *ptrs,
        scratch.data_ptr() + 4 * tiles, stream))
    return scratch[tiles:], packed


def _lanes(n: int, dev):
    """Uninitialised lanes (origin, direction, weight f32[n, 3], pixel
    i64[n]); the three f32 arrays share one allocation."""
    return (*torch.empty((3, n, 3), dtype=_F32, device=dev).unbind(0),
            torch.empty(n, dtype=_I64, device=dev))


def falling_keys(w, idx):
    """The keys ``scatter_kernel`` writes for the lanes ``idx`` i64[n] of
    weights ``w`` f32[m, 3], plain: i64[n] whose ascending order is a stable
    sort by falling ``max_comp(w)`` (zeros of either sign tie, NaN last),
    ``torch.argsort(-score, stable=True)``'s order."""
    score = vm.max_comp(w.index_select(0, idx))
    score = torch.where(score == 0, torch.zeros_like(score), score)
    bits = score.view(torch.int32).to(torch.int64) & 0xffffffff
    rising = torch.where(bits >= 2 ** 31, bits ^ 0xffffffff, bits | 2 ** 31)
    falling = torch.where(torch.isnan(score), 0xffffffff, rising ^ 0xffffffff)
    # the high word as a signed 32-bit integer: falling with its top bit
    # flipped
    return (falling - 2 ** 31) * 2 ** 32 + idx


def sorted_lanes(keys, n: int, kept: int, lanes, path: str):
    """The lanes of the first ``kept`` of the ``n`` keys in ascending order,
    sorted by ``path``: ``block`` (one launch; ``n`` at most
    :func:`sort_threshold`; each block sorts the keys and gathers
    ``GATHER_ROWS`` lanes) or ``library`` (``torch.sort``, then one
    launch)."""
    ro, rd, w, pixel = lanes
    if path not in ('block', 'library') or not 0 <= kept <= n or (
            path == 'block' and n > sort_threshold(ro.device)):
        raise ValueError(f'whitted_lanes: cannot sort {n} keys by {path!r}')
    out = _lanes(kept, ro.device)
    if not kept:
        return out
    lib, stream = kernels.library(), kernels.stream_of(ro)
    ins = tuple(a.data_ptr() for a in lanes)
    outs = tuple(a.data_ptr() for a in out)
    if path == 'block':
        _launched(lib.cpt_whitted_sort_gather(keys.data_ptr(), n, kept,
                                              GATHER_ROWS, *ins, *outs,
                                              stream))
    else:
        ordered_keys = torch.sort(keys[:n]).values
        _launched(lib.cpt_whitted_gather(ordered_keys.data_ptr(), kept, *ins,
                                         *outs, stream))
    kernels.LAUNCHES[f'whitted_sort_{path}'] += 1
    return out
