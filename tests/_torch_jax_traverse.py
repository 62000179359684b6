"""Run one of the JAX package's traversal Pallas kernels (interpret mode) on
the small room and save its hits: ``traverse_packet2`` (v2) for
``test_torch_traverse.py``, ``traverse_packet`` (v1) for
``test_torch_traverse_packet.py``.

Runs in its own process so the test can give XLA ``--xla_cpu_max_isa=AVX``:
without FMA instructions XLA's CPU code rounds every product and sum the way
the port does, so ``t`` can be compared bit for bit (with FMA, XLA contracts
``a*b + c`` and ``t`` moves by a few ulp). Usage:
``python _torch_jax_traverse.py OUT.npz SHARE`` (v2 with that share-K
schedule) or ``python _torch_jax_traverse.py OUT.npz v1`` (v1, once as a
closest-hit call whose stop-on-hit lanes end at their first hit, once as an
any-hit call on every lane, saved with the prefix ``any_``).
"""
import os
import sys

import numpy as np

N_RAYS = 2048


def rays():
    """2048 rays: the 32x24 camera rays plus random rays from inside the
    room, with per-lane t_max, active and stop_on_hit draws."""
    import jax.numpy as jnp
    from _torch_room import CAMERA
    from cuda_pathtracer_tpu.core import camera as jcam
    from cuda_pathtracer_tpu.core import rng as jrng
    W, H = 32, 24
    ys, xs = np.mgrid[0:H, 0:W]
    xs, ys = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    seeds = jrng.get_seed(jnp.asarray(xs), jnp.asarray(ys), 0, W)
    co, cd, _ = jcam.generate_rays(jcam.Camera.create(**CAMERA),
                                   jnp.asarray(xs), jnp.asarray(ys), seeds, W, H)
    rs = np.random.RandomState(11)
    n = N_RAYS - W * H
    o = rs.uniform([-2.9, 0.05, -1.9], [2.9, 3.9, 3.9], (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = np.concatenate([np.asarray(co), o]).astype(np.float32)
    rd = np.concatenate([np.asarray(cd), d]).astype(np.float32)
    # lanes: a quarter any-hit with a short t_max, a quarter inactive
    lane = rs.permutation(N_RAYS) % 4
    stop = lane == 0
    active = lane != 1
    t_max = np.where(stop, rs.uniform(0.2, 4.0, N_RAYS),
                     9999999.0).astype(np.float32)
    return ro, rd, t_max, active, stop


def main(out: str, mode: str):
    import jax
    import jax.numpy as jnp
    from _torch_room import build_room
    from cuda_pathtracer_tpu.ops import traverse_packet as jtp
    from cuda_pathtracer_tpu.ops import traverse_packet2 as jtp2
    from cuda_pathtracer_tpu.scene import scene as js
    from cuda_pathtracer_tpu_torch.scene.builder import add_cube
    jax.config.update('jax_platforms', 'cpu')
    scene = build_room(js, add_cube)
    arr, dyn = scene.to_device(), scene.dynamic_arrays()
    ro, rd, t_max, active, stop = rays()
    J = jnp.asarray
    saved = dict(ro=ro, rd=rd, t_max=t_max, active=active, stop=stop)
    if mode == 'v1':
        tables = jtp.PacketTables(dyn.packet_inner, dyn.packet_leaf,
                                  scene.wide_depth)
        h = jtp.traverse_packet(arr, tables, J(ro), J(rd), t_max=J(t_max),
                                active=J(active), stop_on_hit=J(stop),
                                interpret=True)
        ha = jtp.traverse_packet(arr, tables, J(ro), J(rd), t_max=J(t_max),
                                 active=J(active), any_hit=True,
                                 interpret=True)
        saved.update({'any_' + k: np.asarray(v)
                      for k, v in ha._asdict().items() if v is not None})
    else:
        table = jtp2.MergedTable(dyn.packet_merged, scene.wide_depth)
        h = jtp2.traverse_packet2(arr, table, J(ro), J(rd), t_max=J(t_max),
                                  active=J(active), stop_on_hit=J(stop),
                                  interpret=True, share=int(mode),
                                  want_uv=True)
    saved.update({k: np.asarray(v) for k, v in h._asdict().items()
                  if v is not None})
    np.savez(out, **saved)


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1], sys.argv[2])
