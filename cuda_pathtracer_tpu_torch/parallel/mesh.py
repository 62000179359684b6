"""Rendering over several ranks: band sharding over ``torch.distributed``
(counterpart of ``cuda_pathtracer_tpu/parallel/mesh.py``).

The reference is single-GPU; a frame is data-parallel over pixels. The JAX
package places whole bands on the devices of a mesh in one program
(``shard_map``). The port runs one process per rank instead, PyTorch's own
idiom for data parallelism: the engine is host-bound (a few thousand
launches per bounce body and a host sync per bounce), so one Python
process driving several devices would serialize their host loops.

:class:`ShardedPathtracer` is a thin subclass of the single engine: rank
``r`` renders bands ``[r * per, (r + 1) * per)`` with the engine's own band
loop and holds only their accumulators. Every band runs the same
``render_sample`` as in the single engine, so its random streams are the
same; only the guiding sums are added in another order. A sample's only
collectives, which every rank enters in this order: an all-reduce (sum) of
the bands' raw guiding sums and counts before the nonlinear EMA (when the
sample trains guiding, which the replicated host state decides alike on
every rank), an all-reduce (max) of ``rand_idx`` and an all-reduce (sum) of
the rays traced. The accumulators travel only when a frame is read
(:meth:`ShardedPathtracer.gather_lanes`).

The backend is NCCL when every rank has a card of its own (the ranks compare
their cards' UUIDs), else gloo (ranks on the CPU, or ranks that share one
card: NCCL refuses two ranks on one device). gloo takes CUDA tensors only
for some collectives, so under gloo the collectives move host copies.
"""
from __future__ import annotations

import datetime
import os
import sys

import torch

from ..models import film
from ..models.pathtracer import Pathtracer, tile_unpermute

# a rank that does not come, or a collective that one rank never enters,
# fails after this long instead of hanging every other rank
TIMEOUT_S = 60


def mesh_geometry(width: int, height: int, bands: int, n: int):
    """(frame height, band count) of a frame sharded over ``n`` ranks:
    the smallest multiple of ``n`` from the single engine's ``bands`` up
    that divides the height, preferring bands of a multiple of 8 rows when
    the width tiles. When no count divides the height, the frame is padded
    to the next height that one does, to an 8-row-aligned band when that
    costs at most ``max(8 * b0, height // 4)`` rows (the JAX engine's
    rule; 1080p: 6 bands of 180 rows at n = 2, 8 of 135 at n = 4)."""
    def count(h):
        best = None
        b = -(-bands // n) * n
        while b <= h:
            if h % b == 0:
                if (h // b) % 8 == 0 or width % 16:
                    return b
                if best is None:
                    best = b
            b += n
        return best

    best = count(height)
    if best is not None:
        return height, best
    b0 = -(-bands // n) * n
    padded = -(-height // b0) * b0
    if width % 16 == 0 and (padded // b0) % 8:
        aligned = -(-height // (b0 * 8)) * (b0 * 8)
        if aligned - height <= max(8 * b0, height // 4):
            padded = aligned
    best = count(padded)
    if best is None:
        raise ValueError(f'no band count for {width}x{padded} over {n} ranks')
    return padded, best


def device_identity(device) -> str:
    """What tells this rank's device from another rank's: the card's UUID,
    whatever a launcher made visible to each rank, else the device type."""
    device = torch.device(device)
    if device.type != 'cuda':
        return device.type
    return f'cuda {torch.cuda.get_device_properties(device).uuid}'


def choose_backend(identities: list) -> str:
    """``nccl`` when every rank renders on a card of its own (the ranks'
    :func:`device_identity` values are all cards and all distinct), else
    ``gloo``."""
    cards = [i for i in identities if i.startswith('cuda ')]
    if len(cards) == len(identities) == len(set(cards)):
        return 'nccl'
    return 'gloo'


class Group:
    """This rank's place in the process group and the collectives the
    engine needs, on tensors of any device."""

    def __init__(self, rank: int, world: int, backend: str, device):
        self.rank, self.world, self.backend = rank, world, backend
        self.device = torch.device(device)

    def _wire(self, t):
        """The tensor the backend takes: a host copy of a CUDA tensor
        under gloo, else ``t`` itself."""
        if self.backend == 'gloo' and t.is_cuda:
            return t.cpu()
        return t.contiguous()

    def all_reduce(self, t, op: str = 'sum'):
        """The element-wise sum (or max) of ``t`` over the ranks, on
        ``t``'s device (``t`` itself may be overwritten)."""
        import torch.distributed as dist
        x = self._wire(t)
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op == 'sum'
                        else dist.ReduceOp.MAX)
        return x.to(t.device)

    def all_reduce_int(self, v: int, op: str) -> int:
        dev = self.device if self.backend == 'nccl' else 'cpu'
        return int(self.all_reduce(
            torch.tensor([v], dtype=torch.int64, device=dev), op))

    def all_gather(self, t):
        """Every rank's ``t`` (one shape on every rank), concatenated in
        rank order along dim 0, on ``t``'s device."""
        import torch.distributed as dist
        x = self._wire(t)
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts).to(t.device)

    def share(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank."""
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def init_group(device, rank: int | None = None, world: int | None = None,
               store: str | None = None) -> Group:
    """Join the process group. Without ``rank``, from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); else as
    rank ``rank`` of ``world`` ranks that meet at the file ``store``.
    ``device`` is this rank's render device. The ranks first exchange their
    devices' identities through the rendezvous store, so that all of them
    choose the same backend; rank 0 prints it and why."""
    import torch.distributed as dist
    from torch.distributed.rendezvous import rendezvous
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if rank is None:
        url, rank, world = ('env://', int(os.environ['RANK']),
                            int(os.environ['WORLD_SIZE']))
    else:
        url = f'file://{os.path.abspath(store)}'
    kv, rank, world = next(rendezvous(url, rank, world, timeout=timeout))
    kv.set_timeout(timeout)
    device = torch.device(device)
    kv.set(f'cpt_device/{rank}', device_identity(device))
    ids = [kv.get(f'cpt_device/{r}').decode() for r in range(world)]
    backend = choose_backend(ids)
    if backend == 'nccl':
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=kv, rank=rank, world_size=world,
                            timeout=timeout)
    if rank == 0:
        why = ('a card per rank' if backend == 'nccl' else
               'ranks on the CPU' if all(i == 'cpu' for i in ids) else
               'ranks share a card' if len(set(ids)) < len(ids) else
               'not every rank on a card')
        print(f'shard: {world} ranks, backend {backend} ({why})',
              file=sys.stderr)
    return Group(rank, world, backend, device)


def close_group():
    """Leave the process group (every rank calls it at the end)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class ShardedPathtracer(Pathtracer):
    """The progressive renderer with the frame's bands split over the ranks
    of a process group: the host API of :class:`Pathtracer`, called by
    every rank alike (``render``, ``image``, ``energy`` and
    ``accumulators_pixel_order`` are collective).

    Any size the single engine takes works: when no band count that is a
    multiple of the rank count divides the height, the frame is padded
    (:func:`mesh_geometry`); the pad rows trace rays below the frustum
    (the camera frames the requested height) and are cropped from
    ``image()`` and ``energy()``. ``height`` is the padded height, the
    requested one is ``out_height``."""

    def __init__(self, scene, width: int = 640, height: int = 480, *,
                 group: Group, skydome: str | None = None,
                 blue_noise: str | None = None, spp: int | None = None):
        self.group = group
        self.rank, self.world = group.rank, group.world
        self.out_height = height
        super().__init__(scene, width, height, device=group.device,
                         skydome=skydome, blue_noise=blue_noise, spp=spp)
        self.height, bands = mesh_geometry(width, height, self.bands,
                                           self.world)
        self._set_bands(bands)
        self._clear_accumulators()
        if width % 16 == 0 and not self.tile_order and self.rank == 0:
            print(f'mesh: band_h={self.band_h} not tile-aligned; '
                  f'tile-packet layout disabled for this geometry')

    def _owned_bands(self) -> range:
        # until __init__ sets the mesh geometry (a multiple of the rank
        # count), the single engine's bands may not split evenly
        per = self.bands // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    def _full_height(self) -> int:
        return self.out_height

    def _sample_dispatch(self, camera, guide: bool, max_bounces: int,
                         spp: int):
        ridx, rays, sums = self._render_bands(camera, guide, max_bounces, spp)
        if guide:
            both = self.group.all_reduce(torch.stack(sums))
            self._propagate(both[0], both[1], spp)
        ridx = self.group.all_reduce_int(ridx, 'max')
        rays = self.group.all_reduce(rays)
        return ridx, rays

    # ---- the frame, gathered (every rank calls these) ----

    def gather_lanes(self):
        """(lum, alb) of the whole padded frame in lane order, on every
        rank (collective)."""
        return self.group.all_gather(self.lum), self.group.all_gather(self.alb)

    def keep_lanes(self, lum, alb):
        """Keep this rank's bands of whole-frame lane-order accumulators."""
        n = self.band_h * self.width
        own = self._owned_bands()
        sl = slice(own.start * n, own.stop * n)
        self.lum, self.alb = lum[sl].clone(), alb[sl].clone()

    def accumulators_pixel_order(self):
        """(lum, alb) of the padded frame in row-major pixel order, on
        every rank."""
        lum, alb = self.gather_lanes()
        if self.tile_order:
            return tuple(tile_unpermute(a, self.width, self.band_h,
                                        self.bands) for a in (lum, alb))
        return lum, alb

    def image(self, blur: bool = False):
        """The display image of the requested frame on rank 0; None on the
        other ranks."""
        lum, alb = self.accumulators_pixel_order()
        if self.rank:
            return None
        k = self.out_height * self.width
        return film.display(lum[:k], alb[:k], float(self.sample_idx),
                            self.width, self.out_height, blur=blur)

    def energy(self):
        if self.height == self.out_height:
            lum, _ = self.gather_lanes()
        else:
            lum = self.accumulators_pixel_order()[0][
                :self.out_height * self.width]
        total, has_nan, has_neg = film.energy_audit(lum)
        return float(total), bool(has_nan), bool(has_neg)
