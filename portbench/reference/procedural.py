"""Procedural stand-in geometry for reference scenes whose OBJ assets are not
shipped in the repo (sibenik.obj, lucy.obj, vokselia_spawn.obj, 2Mtris.obj —
only their .mtl files exist). Each generator matches the missing asset's rough
scale and triangle count so the named scenes stay runnable and the benchmarks
stress the same regimes (interior multi-bounce, voxel world, 2M-tri BVH).

A frozen copy of the port's ``scene/procedural.py`` (itself the JAX
package's): it makes the benchmark's input data, the stand-in triangles the
reference renders, the way a model's benchmark makes its weights; nothing of
the rendering is here.
"""
from __future__ import annotations

import numpy as np


def _quads_to_tris(p00, p10, p01, p11):
    """Two triangles per quad; inputs [N, 3]."""
    v0 = np.concatenate([p00, p00])
    v1 = np.concatenate([p10, p11])
    v2 = np.concatenate([p11, p01])
    return v0, v1, v2


def _grid_surface_uv(f, nu, nv, tile=(1.0, 1.0)):
    """Like _grid_surface but also emits per-corner texture coordinates
    (the parametric (u, v) scaled by `tile` repeats) so the procedural
    stand-ins exercise the texture-sampling path like the reference's
    MTL-textured assets do."""
    us = np.linspace(0.0, 1.0, nu + 1)
    vs = np.linspace(0.0, 1.0, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing='ij')
    pts = f(uu, vv)
    tuv = np.stack([uu * tile[0], vv * tile[1]], -1)   # [nu+1, nv+1, 2]

    def corners(a):
        return (a[:-1, :-1].reshape(len(us) - 1, len(vs) - 1, -1),
                a[1:, :-1].reshape(len(us) - 1, len(vs) - 1, -1),
                a[:-1, 1:].reshape(len(us) - 1, len(vs) - 1, -1),
                a[1:, 1:].reshape(len(us) - 1, len(vs) - 1, -1))

    p00, p10, p01, p11 = (c.reshape(-1, 3) for c in corners(pts))
    t00, t10, t01, t11 = (c.reshape(-1, 2) for c in corners(tuv))
    v0, v1, v2 = _quads_to_tris(p00, p10, p01, p11)
    u0 = np.concatenate([t00, t00])
    u1 = np.concatenate([t10, t11])
    u2 = np.concatenate([t11, t01])
    uv6 = np.concatenate([u0, u1, u2], axis=1).astype(np.float32)
    return v0, v1, v2, uv6


def _stone_texture(size=128, seed=5):
    """Procedural stone-like texture (value noise + mortar lines) standing
    in for kamen.png on scenes whose real assets the reference doesn't
    ship."""
    rng = np.random.RandomState(seed)
    img = np.zeros((size, size), np.float32)
    for octave in (8, 16, 32):
        g = rng.rand(octave + 1, octave + 1).astype(np.float32)
        ys, xs = np.mgrid[0:size, 0:size] * (octave / size)
        x0, y0 = xs.astype(int), ys.astype(int)
        fx, fy = xs - x0, ys - y0
        v = (g[y0, x0] * (1 - fx) * (1 - fy) + g[y0, x0 + 1] * fx * (1 - fy)
             + g[y0 + 1, x0] * (1 - fx) * fy + g[y0 + 1, x0 + 1] * fx * fy)
        img += v / (octave / 8)
    img = 0.45 + 0.4 * (img - img.min()) / (np.ptp(img) + 1e-9)
    # mortar lines every 32 texels
    img[::32, :] *= 0.55
    img[:, ::32] *= 0.55
    return np.repeat(img[:, :, None], 3, axis=2)


def _grid_surface(f, nu, nv):
    """Tessellate parametric surface f(u, v)->[...,3] on an (nu+1)x(nv+1) grid."""
    us = np.linspace(0.0, 1.0, nu + 1)
    vs = np.linspace(0.0, 1.0, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing='ij')
    pts = f(uu, vv)  # [nu+1, nv+1, 3]
    p00 = pts[:-1, :-1].reshape(-1, 3)
    p10 = pts[1:, :-1].reshape(-1, 3)
    p01 = pts[:-1, 1:].reshape(-1, 3)
    p11 = pts[1:, 1:].reshape(-1, 3)
    return _quads_to_tris(p00, p10, p01, p11)


def _icosphere(subdiv: int):
    """Subdivided icosahedron -> (verts, faces)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        v0 = verts[faces[:, 0]]
        v1 = verts[faces[:, 1]]
        v2 = verts[faces[:, 2]]
        m01 = (v0 + v1) / 2
        m12 = (v1 + v2) / 2
        m20 = (v2 + v0) / 2
        n = len(faces)
        base = len(verts)
        verts = np.concatenate([verts, m01, m12, m20])
        i01 = base + np.arange(n)
        i12 = base + n + np.arange(n)
        i20 = base + 2 * n + np.arange(n)
        faces = np.concatenate([
            np.stack([faces[:, 0], i01, i20], 1),
            np.stack([faces[:, 1], i12, i01], 1),
            np.stack([faces[:, 2], i20, i12], 1),
            np.stack([i01, i12, i20], 1)])
        verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return verts, faces


def _displaced_sphere(subdiv: int, seed=0, amp=0.35, freq=4.0):
    """Fractally displaced icosphere — a stand-in for scanned statues."""
    verts, faces = _icosphere(subdiv)
    rng = np.random.RandomState(seed)
    disp = np.zeros(len(verts))
    for octave in range(4):
        phase = rng.rand(3) * 6.28
        k = freq * (2 ** octave)
        disp += (amp / (2 ** octave)) * (
            np.sin(k * verts[:, 0] + phase[0])
            * np.sin(k * verts[:, 1] + phase[1])
            * np.sin(k * verts[:, 2] + phase[2]))
    verts = verts * (1.0 + disp)[:, None]
    v0 = verts[faces[:, 0]].astype(np.float32)
    v1 = verts[faces[:, 1]].astype(np.float32)
    v2 = verts[faces[:, 2]].astype(np.float32)
    return v0, v1, v2


def add_statue(scene, material: int, scale=2.0, offset=(3, 0, 4.0)) -> int:
    """~80k-tri displaced sphere standing in for lucy.obj."""
    v0, v1, v2 = _displaced_sphere(6, seed=1)
    off = np.asarray(offset, np.float32)
    return scene.add_mesh(v0 * scale + off, v1 * scale + off, v2 * scale + off,
                          material)


def add_high_poly_statue(scene, material: int, target_tris=2_000_000) -> int:
    """~2M-tri model standing in for 2Mtris.obj (the lucy scan,
    the reference, src/sceneBuilder.h:241-261): a TALL THIN statue-like
    body of revolution with fractal surface detail.

    The previous stand-in (stacked displaced icospheres) was a far harder
    traversal workload than the reference's: lucy is a slender statue in
    open space — bounce rays escape after a shallow walk — while fat
    wrinkled spheres trap bounce wavefronts in concavities (measured 9.7
    union visits/ray vs sibenik's 2.2, tools/visit_count.py). This shape
    matches the reference scene's occupancy character: ~2.7:1 height:width
    (the Stanford lucy's proportions), moderate relief, open surroundings.

    Built along +z so the scene's rotation[0] = -pi/2 (mirroring the
    reference's lucy orientation fix) stands it upright along +y.
    """
    rng = np.random.RandomState(7)
    nu = int(np.sqrt(target_tris / 2 / 5)) * 2       # around the axis
    nv = -(-target_tris // (2 * nu))                 # along the axis
    u = (np.arange(nu + 1) / nu)[None, :]            # wraps at 1
    v = (np.arange(nv + 1) / nv)[:, None]
    theta = 2 * np.pi * u
    # statue silhouette: pedestal, body, shoulders, head
    prof = (0.55 + 1.65 * np.sin(np.pi * np.clip(v, 0.02, 0.98)) ** 0.8
            * (1.0 - 0.35 * v))
    # fractal relief (drapery-scale, small relative amplitude)
    disp = np.zeros((nv + 1, nu + 1))
    for octave in range(4):
        ph = rng.rand(3) * 6.28
        k = 5.0 * (2 ** octave)
        disp += (0.10 / (2 ** octave)) * (
            np.sin(k * theta + ph[0]) * np.sin(0.7 * k * np.pi * v + ph[1])
            + 0.5 * np.sin(1.3 * k * (theta * 0.5 + np.pi * v) + ph[2]))
    disp[:, -1] = disp[:, 0]                         # seam continuity
    r = prof * (1.0 + disp)
    height = 12.0
    x = r * np.cos(theta)
    y = r * np.sin(theta)
    z = height * np.broadcast_to(v, r.shape)
    pts = np.stack([x, y, z], axis=-1).astype(np.float32)  # [nv+1, nu+1, 3]
    p00 = pts[:-1, :-1].reshape(-1, 3)
    p10 = pts[:-1, 1:].reshape(-1, 3)
    p01 = pts[1:, :-1].reshape(-1, 3)
    p11 = pts[1:, 1:].reshape(-1, 3)
    v0, v1, v2 = _quads_to_tris(p00, p10, p01, p11)
    return scene.add_mesh(v0, v1, v2, material)


def add_cathedral(scene, material: int) -> int:
    """Sibenik-scale interior: barrel-vaulted hall with column rows
    (~75k triangles, interior bounce-heavy lighting like the cathedral),
    stone-textured so renders pay the texture-gather cost like the real
    sibenik.mtl assets (kamen.png, sibenik.mtl:39-42)."""
    parts = []

    LX, LY, LZ = 18.0, 10.0, 40.0   # half-width, wall height, length

    def wall(f, nu, nv, tile=(6.0, 12.0)):
        parts.append(_grid_surface_uv(f, nu, nv, tile))

    # floor
    wall(lambda u, v: np.stack([(-LX + 2 * LX * u), 0 * u - 12.0,
                                (-LZ / 2 + LZ * v)], -1), 64, 128)
    # side walls
    wall(lambda u, v: np.stack([0 * u - LX, -12.0 + LY * u,
                                (-LZ / 2 + LZ * v)], -1), 32, 128)
    wall(lambda u, v: np.stack([0 * u + LX, -12.0 + LY * u,
                                (-LZ / 2 + LZ * v)], -1), 32, 128)
    # barrel vault ceiling
    wall(lambda u, v: np.stack([LX * np.cos(np.pi * u),
                                -12.0 + LY + (LX * 0.8) * np.sin(np.pi * u),
                                (-LZ / 2 + LZ * v)], -1), 96, 128)
    # end walls
    wall(lambda u, v: np.stack([(-LX + 2 * LX * u),
                                -12.0 + (LY + LX) * v,
                                0 * u - LZ / 2], -1), 48, 48)
    wall(lambda u, v: np.stack([(-LX + 2 * LX * u),
                                -12.0 + (LY + LX) * v,
                                0 * u + LZ / 2], -1), 48, 48)
    # column rows (cylinders)
    for zi in range(-3, 4):
        for x in (-LX * 0.55, LX * 0.55):
            z0 = zi * 5.5
            wall(lambda u, v, x=x, z0=z0:
                 np.stack([x + 1.0 * np.cos(2 * np.pi * u),
                           -12.0 + LY * v,
                           z0 + 1.0 * np.sin(2 * np.pi * u)], -1), 24, 24)

    v0 = np.concatenate([p[0] for p in parts]).astype(np.float32)
    v1 = np.concatenate([p[1] for p in parts]).astype(np.float32)
    v2 = np.concatenate([p[2] for p in parts]).astype(np.float32)
    uv6 = np.concatenate([p[3] for p in parts]).astype(np.float32)
    scene.materials[material].texture = scene.atlas.add_array(
        _stone_texture())
    return scene.add_mesh(v0, v1, v2, material, uv=uv6)


def add_voxel_world(scene, material: int, n=160, seed=3) -> int:
    """Minecraft-style height-field of cubes (~90k tris) standing in for
    vokselia_spawn.obj."""
    rng = np.random.RandomState(seed)
    base = rng.rand(n // 8 + 2, n // 8 + 2)
    ys, xs = np.mgrid[0:n, 0:n].astype(np.float64) / 8.0
    x0 = xs.astype(int)
    y0 = ys.astype(int)
    fx = xs - x0
    fy = ys - y0
    h = (base[x0, y0] * (1 - fx) * (1 - fy) + base[x0 + 1, y0] * fx * (1 - fy)
         + base[x0, y0 + 1] * (1 - fx) * fy + base[x0 + 1, y0 + 1] * fx * fy)
    heights = np.maximum((h * 6).astype(int), 1)

    # exposed top + 4 side faces per column (height differences)
    cube_faces = []
    unit = 1.0
    for gx in range(n):
        for gz in range(n):
            y = heights[gx, gz] * unit
            x, z = gx - n / 2, gz - n / 2
            # top quad
            cube_faces.append(((x, y, z), (x + 1, y, z), (x, y, z + 1),
                               (x + 1, y, z + 1)))
            for dx, dz in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                nx, nz = gx + dx, gz + dz
                nh = heights[nx, nz] if 0 <= nx < n and 0 <= nz < n else 0
                if nh < heights[gx, gz]:
                    yl, yh = nh * unit, y
                    if dx == 1:
                        q = ((x + 1, yl, z), (x + 1, yh, z), (x + 1, yl, z + 1),
                             (x + 1, yh, z + 1))
                    elif dx == -1:
                        q = ((x, yl, z), (x, yh, z), (x, yl, z + 1), (x, yh, z + 1))
                    elif dz == 1:
                        q = ((x, yl, z + 1), (x, yh, z + 1), (x + 1, yl, z + 1),
                             (x + 1, yh, z + 1))
                    else:
                        q = ((x, yl, z), (x, yh, z), (x + 1, yl, z), (x + 1, yh, z))
                    cube_faces.append(q)

    quads = np.asarray(cube_faces, np.float32)  # [Q, 4, 3]
    p00, p10, p01, p11 = quads[:, 0], quads[:, 1], quads[:, 2], quads[:, 3]
    v0, v1, v2 = _quads_to_tris(p00, p10, p01, p11)
    return scene.add_mesh(v0, v1, v2, material)
