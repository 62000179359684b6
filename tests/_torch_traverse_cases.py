"""Hard cases for both traversal walks: a hand-built wide BVH and rays aimed
at its edges.

The table is written row by row in the ``accel/wide.py`` layout, so both
packages derive their own v1 split tables and v2 merged table from the same
rows. Under the root:

  * ``G``: 13 leaves of 1-12 random triangles in [-4, 4]^3 and an inner
    node of 3 more, the general case (two empty slots: NaN boxes);
  * ``Q``: a square of two triangles in the plane y = 5 with a shared
    diagonal, its box flat in y;
  * ``TL``: one leaf holding the same triangle three times, with ids 310,
    305 and 320 in that slot order (an exact-t tie inside a leaf: id 305);
  * ``X``: two leaves holding the same triangle, id 400 in slot 0 and id 200
    in slot 1, whose box another triangle stretches towards -x (an exact-t
    tie between two leaves: v2 walks slot 0 first, v1 the nearer box first);
  * ``C``: a chain of ``CHAIN`` nested inner nodes around (0, -8, 0), each
    with the next one and a sliver leaf that rays along z pass beside, so a
    ray aimed at the innermost triangle pushes an entry at every level.

Rays, by case (``CASES``): along the axes (zero components, -0.0, and
components below ``safe_inv``'s TINY), grazing box faces and lying in the
square's plane, along box edges, starting inside leaf boxes, at the two
ties, with a t_max shorter than every hit, stop-on-hit, dead, down the chain
from both sides, and random rays. ``python _torch_traverse_cases.py
OUT.npz`` runs the JAX package's kernels on them (interpret mode; v2 with
the sequential ``share=0`` steps, v1 as a closest-hit call and as an any-hit
call) and saves their hits; run it with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``
so that ``t`` compares bit for bit.
"""
import os
import sys

import numpy as np

ROW, ARITY, LEAF_MAX = 128, 16, 12
INNER_BOX0, INNER_REFS, LEAF_TRIS, LEAF_GIDS = 1, 97, 1, 109
CHAIN = 24
CHAIN_CENTER = np.array([0.0, -8.0, 0.0])
CASES = ('axis', 'graze', 'edge', 'inside', 'tie_leaf', 'tie_across',
         'short_t0', 'stop', 'dead', 'chain', 'random')
T_FAR = 9999999.0


def _leaf(tris, gids):
    return ('leaf', np.asarray(tris, np.float32).reshape(-1, 3, 3),
            list(gids))


def _inner(*children):
    return ('inner', list(children))


def _bounds(node):
    if node[0] == 'leaf':
        v = node[1].reshape(-1, 3)
        return v.min(0), v.max(0)
    lo, hi = zip(*(_bounds(c) for c in node[1]))
    return np.min(lo, 0), np.max(hi, 0)


def _emit(node, rows, depth, max_depth):
    """Append ``node`` (pre-order, parent before children) to ``rows``;
    returns its row index."""
    max_depth[0] = max(max_depth[0], depth)
    at = len(rows)
    row = np.zeros(ROW, np.float32)
    rows.append(row)
    if node[0] == 'leaf':
        tris, gids = node[1], node[2]
        n = len(tris)
        assert 1 <= n <= LEAF_MAX
        row[0] = -float(n)
        fm = np.zeros((9, LEAF_MAX), np.float32)
        fm[:, :n] = tris.reshape(n, 9).T
        row[LEAF_TRIS:LEAF_TRIS + 9 * LEAF_MAX] = fm.reshape(-1)
        row[LEAF_GIDS:LEAF_GIDS + n] = np.asarray(gids, np.int32).view(
            np.float32)
        return at
    children = node[1]
    assert 1 <= len(children) <= ARITY
    row[0] = float(len(children))
    box = np.zeros((6, ARITY), np.float32)
    box[0:3] = 3.0e38       # inside-out boxes in the empty slots
    box[3:6] = -3.0e38
    refs = np.zeros(ARITY, np.int32)
    for k, c in enumerate(children):
        box[0:3, k], box[3:6, k] = _bounds(c)
        refs[k] = _emit(c, rows, depth + 1, max_depth)
    row[INNER_BOX0:INNER_BOX0 + 6 * ARITY] = box.reshape(-1)
    row[INNER_REFS:INNER_REFS + ARITY] = refs.view(np.float32)
    return at


def _tree():
    rs = np.random.RandomState(7)
    gid = [0]

    def rand_leaf(n, center):
        tris = center + rs.uniform(-0.6, 0.6, (n, 3, 3))
        ids = list(range(gid[0], gid[0] + n))
        gid[0] += n
        return _leaf(tris, ids)

    general = [rand_leaf(12 if j == 0 else rs.randint(1, 13),
                         rs.uniform(-3, 3, 3)) for j in range(13)]
    general.append(_inner(*(rand_leaf(rs.randint(1, 13), rs.uniform(-3, 3, 3))
                            for _ in range(3))))
    quad = _leaf([[(-2, 5, -2), (2, 5, -2), (2, 5, 2)],
                  [(-2, 5, -2), (2, 5, 2), (-2, 5, 2)]], [900, 901])
    tri = [(-1, -1, 6), (1, -1, 6), (0, 1, 6)]
    tie_leaf = _leaf([tri, [(-1, 2, 6.5), (1, 2, 6.5), (0, 3, 6.5)], tri,
                      tri], [310, 500, 305, 320])
    dup = [(-6, -1, -1), (-6, 1, -1), (-6, 0, 1)]
    stretch = [(-7.5, 2, 2), (-7.5, 2.5, 2), (-7.5, 2, 2.5)]
    tie_across = _inner(_leaf([dup], [400]), _leaf([dup, stretch], [200, 410]))
    # the chain: level j holds level j + 1 and a sliver along the diagonal
    # y = x, in the plane z = -s_j / 2, that rays at (-q, q) pass beside
    c = CHAIN_CENTER
    s_in = 0.8 ** CHAIN
    node = _leaf([c + np.array([(-2 * s_in, -2 * s_in, 0),
                                (2 * s_in, -2 * s_in, 0), (0, 2 * s_in, 0)])],
                 [7000])
    for j in reversed(range(CHAIN)):
        s = 0.8 ** j
        sliver = c + np.array([(-s, -s, -s / 2), (s, s, -s / 2),
                               (s, s * 0.9, -s / 2)])
        node = _inner(node, _leaf([sliver], [7001 + j]))
    return _inner(_inner(*general), quad, tie_leaf, tie_across, node)


def wide_table():
    """(rows f32[N, 128] in the wide layout, tree depth with the root at 1)."""
    rows, max_depth = [], [0]
    _emit(_tree(), rows, 1, max_depth)
    return np.stack(rows), max_depth[0]


def leaf_boxes():
    """(lo, hi) of every leaf of the general subtree."""
    out = []

    def walk(node):
        if node[0] == 'leaf':
            out.append(_bounds(node))
        else:
            for c in node[1]:
                walk(c)
    walk(_tree()[1][0])
    return out


def _unit(d):
    d = np.asarray(d, np.float64)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def rays():
    """dict(ro, rd, t_max, active, stop, case): the rays of every case, with
    ``case`` an index into ``CASES``."""
    rs = np.random.RandomState(3)
    parts = []

    def add(name, ro, rd, t_max=T_FAR, active=True, stop=False):
        ro = np.asarray(ro, np.float32).reshape(-1, 3)
        n = len(ro)
        rd = np.broadcast_to(np.asarray(rd, np.float32), (n, 3))
        parts.append(dict(
            ro=ro, rd=rd, t_max=np.broadcast_to(np.float32(t_max), n),
            active=np.broadcast_to(active, n),
            stop=np.broadcast_to(stop, n),
            case=np.full(n, CASES.index(name), np.int32)))

    # along the axes: exact zeros, -0.0, and components below TINY (1e-20)
    axes = []
    for a in range(3):
        for s in (1.0, -1.0):
            for z in (0.0, -0.0, 1e-25, -1e-30):
                d = [z, z, z]
                d[a] = s
                axes.append(d)
    origins = rs.uniform(-3.5, 3.5, (len(axes), 3))
    add('axis', origins, np.asarray(axes, np.float32))
    add('axis', np.zeros((len(axes), 3)), np.asarray(axes, np.float32))

    # grazing: along the top and the back face of each leaf box, and in the
    # plane of the flat square (origin inside its x/z extent or not)
    for lo, hi in leaf_boxes():
        mid = (lo + hi) / 2
        add('graze', [lo[0] - 1, hi[1], mid[2]], [1, 0, 0])
        add('graze', [mid[0], lo[1] - 1, lo[2]], [0, 1, 0])
    add('graze', [[0, 5, 0.3], [-3, 5, 0.3], [0.5, 5, -3]],
        [[1, 0, 0], [1, 0, 0], [0, 0, 1]])
    # onto the square's shared diagonal (a tie inside one leaf, or not)
    add('graze', [[a, 8, a] for a in (-1.0, -0.25, 0.0, 0.5, 1.5)], [0, -1, 0])

    # along an edge of each leaf box: where a triangle's vertex lies on the
    # edge, the slab test's rounding decides whether the walk sees it
    for lo, hi in leaf_boxes():
        add('edge', [hi[0], hi[1], lo[2] - 1], [0, 0, 1])
        add('edge', [lo[0], hi[1] + 1, lo[2]], [0, -1, 0])

    # origins inside leaf boxes, random directions
    for lo, hi in leaf_boxes():
        add('inside', rs.uniform(lo, hi, (3, 3)), _unit(rs.normal(size=(3, 3))))

    # exact-t ties: three copies in one leaf, two copies across two leaves
    xy = rs.uniform(-0.3, 0.3, (16, 2)) + [0, -0.4]
    add('tie_leaf', np.c_[xy, np.full(16, 10.0)], [0, 0, -1])
    yz = rs.uniform(-0.3, 0.3, (16, 2)) + [0, -0.4]
    add('tie_across', np.c_[np.full(16, -10.0), yz], [1, 0, 0])
    add('tie_across', np.c_[np.full(16, -10.0), yz]
        + rs.uniform(-0.2, 0.2, (16, 3)) * [0, 1, 1],
        _unit([[4, 0, 0]] + rs.normal(size=(16, 3)) * 0.02))

    # t_max shorter than every hit
    add('short_t0', rs.uniform(-3, 3, (32, 3)), _unit(rs.normal(size=(32, 3))),
        t_max=1e-4)
    add('short_t0', np.c_[xy, np.full(16, 10.0)], [0, 0, -1], t_max=3.99)

    # stop on the first hit: random, onto the ties and down the chain
    q = 0.1 * 0.8 ** CHAIN
    down = CHAIN_CENTER + [-q, q, 5]
    add('stop', rs.uniform(-3, 3, (32, 3)), _unit(rs.normal(size=(32, 3))),
        stop=True)
    add('stop', np.c_[xy, np.full(16, 10.0)], [0, 0, -1], stop=True)
    add('stop', np.c_[np.full(16, -10.0), yz], [1, 0, 0], stop=True)
    add('stop', [down] * 4, [0, 0, -1], stop=True)

    # dead lanes, aimed at geometry
    add('dead', rs.uniform(-3, 3, (32, 3)), _unit(rs.normal(size=(32, 3))),
        active=False)
    add('dead', [down] * 4, [0, 0, -1], active=False, stop=True)

    # down the chain, from above and from below, beside the slivers
    jitter = rs.uniform(-0.5, 0.5, (16, 2)) * q
    add('chain', np.c_[jitter, np.zeros(16)] + down, [0, 0, -1])
    add('chain', np.c_[jitter, np.zeros(16)] + CHAIN_CENTER + [-q, q, -5],
        [0, 0, 1])

    # random rays through everything, a quarter stop-on-hit, a quarter dead
    n = 192
    lane = rs.permutation(n) % 4
    add('random', rs.uniform(-4.5, 4.5, (n, 3)), _unit(rs.normal(size=(n, 3))),
        active=lane != 1, stop=lane == 0)

    return {k: np.ascontiguousarray(np.concatenate([p[k] for p in parts]))
            for k in parts[0]}


def main(out: str):
    import types
    import jax
    import jax.numpy as jnp
    from cuda_pathtracer_tpu.ops import traverse_packet as jtp
    from cuda_pathtracer_tpu.ops import traverse_packet2 as jtp2
    jax.config.update('jax_platforms', 'cpu')
    wide, depth = wide_table()
    z = rays()
    # no spheres or planes: the prepass leaves t = t_max
    scene = types.SimpleNamespace(sphere_pos=np.zeros((0, 3), np.float32),
                                  plane_normal=np.zeros((0, 3), np.float32))
    J = jnp.asarray
    common = dict(t_max=J(z['t_max']), active=J(z['active']), interpret=True)
    merged = jtp2.build_merged_table(wide, depth)
    h2 = jtp2.traverse_packet2(scene, jtp2.MergedTable(J(merged.rows), depth),
                               J(z['ro']), J(z['rd']), stop_on_hit=J(z['stop']),
                               share=0, want_uv=True, **common)
    tables = jtp.split_packet_tables(wide, depth)
    h1 = jtp.traverse_packet(scene, tables, J(z['ro']), J(z['rd']),
                             stop_on_hit=J(z['stop']), **common)
    ha = jtp.traverse_packet(scene, tables, J(z['ro']), J(z['rd']),
                             any_hit=True, **common)
    saved = {}
    for prefix, h in (('v2_', h2), ('v1_', h1), ('any_', ha)):
        saved.update({prefix + k: np.asarray(v) for k, v in h._asdict().items()
                      if v is not None})
    np.savez(out, **saved)


if __name__ == '__main__':
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1])
