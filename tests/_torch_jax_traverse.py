"""Run the JAX package's ``traverse_packet2`` Pallas kernel (interpret mode)
on the small room and save its hits, for ``test_torch_traverse.py``.

Runs in its own process so the test can give XLA ``--xla_cpu_max_isa=AVX``:
without FMA instructions XLA's CPU code rounds every product and sum the way
the port does, so ``t`` can be compared bit for bit (with FMA, XLA contracts
``a*b + c`` and ``t`` moves by a few ulp). Usage:
``python _torch_jax_traverse.py OUT.npz SHARE``.
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


def main(out: str, share: int):
    import jax
    import jax.numpy as jnp
    from _torch_room import build_room
    from cuda_pathtracer_tpu.ops import traverse_packet2 as jtp2
    from cuda_pathtracer_tpu.scene import scene as js
    from cuda_pathtracer_tpu_torch.scene.builder import add_cube
    jax.config.update('jax_platforms', 'cpu')
    scene = build_room(js, add_cube)
    arr, dyn = scene.to_device(), scene.dynamic_arrays()
    table = jtp2.MergedTable(dyn.packet_merged, scene.wide_depth)
    ro, rd, t_max, active, stop = rays()
    h = jtp2.traverse_packet2(arr, table, jnp.asarray(ro), jnp.asarray(rd),
                              t_max=jnp.asarray(t_max),
                              active=jnp.asarray(active),
                              stop_on_hit=jnp.asarray(stop),
                              interpret=True, share=share, want_uv=True)
    np.savez(out, ro=ro, rd=rd, t_max=t_max, active=active, stop=stop,
             **{k: np.asarray(v) for k, v in h._asdict().items()})


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1], int(sys.argv[2]))
