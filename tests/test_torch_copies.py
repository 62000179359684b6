"""The port's own copies of the JAX package's numpy host modules build the
same BVHs, bit for bit: ``build_bvh`` (the native C++ builder, compiled by
each package from its own copy of the source with the same flags, or the
numpy fallback), ``thread_bvh``, ``build_world_bvh``, ``build_wide_bvh``,
``build_world_wide``, ``build_merged_table`` and ``split_packet_tables``, on
the small room and on the procedural statue, plus the constants and the OBJ
loader. Binary BVHs compare in depth-first order (:func:`_canonical`)."""
import numpy as np
import pytest

from _torch_room import build_room
from cuda_pathtracer_tpu import constants as jconst
from cuda_pathtracer_tpu.accel import bvh as jbvh, native as jnative
from cuda_pathtracer_tpu.accel import flatten as jflat, toplevel as jtop
from cuda_pathtracer_tpu.accel import wide as jwide
from cuda_pathtracer_tpu.ops import traverse_packet as jtp
from cuda_pathtracer_tpu.ops import traverse_packet2 as jtp2
from cuda_pathtracer_tpu.scene import objloader as jobj, procedural as jproc
from cuda_pathtracer_tpu.scene import scene as js
from cuda_pathtracer_tpu_torch import constants as tconst
from cuda_pathtracer_tpu_torch.accel import bvh as tbvh, native as tnative
from cuda_pathtracer_tpu_torch.accel import flatten as tflat, toplevel as ttop
from cuda_pathtracer_tpu_torch.accel import wide as twide
from cuda_pathtracer_tpu_torch.ops import traverse_packet as ttp
from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as ttp2
from cuda_pathtracer_tpu_torch.scene import objloader as tobj, procedural as tproc
from cuda_pathtracer_tpu_torch.scene import scene as ts
from cuda_pathtracer_tpu_torch.scene.builder import add_cube


def _same(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if got.dtype.kind == 'f':
        got, want = got.view(np.int32 if got.itemsize == 4 else np.int64), \
            want.view(np.int32 if want.itemsize == 4 else np.int64)
    np.testing.assert_array_equal(got, want, err_msg=name)


def _same_tuple(got, want, name):
    assert type(got).__name__ == type(want).__name__
    fields = set(got._fields)
    assert fields <= set(want._fields), name
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(g, (int, np.integer)):
            assert g == w, (name, f)
        else:
            _same(g, w, f'{name}.{f}')


def _canonical(nodes):
    """A binary BVH in depth-first order. The native builder numbers nodes
    from a counter its OpenMP threads share, so two builds of the same tree
    may number them differently; the tree itself is deterministic."""
    order, stack = [], [0]
    while stack:
        i = stack.pop()
        order.append(i)
        if nodes.leaf_count[i] == 0:
            stack += [int(nodes.left[i]) + 1, int(nodes.left[i])]
    order = np.asarray(order)
    new_of = np.empty(len(nodes.vmin), np.int64)
    new_of[order] = np.arange(len(order))
    inner = nodes.leaf_count[order] == 0
    left = np.where(inner, new_of[np.where(inner, nodes.left[order], 0)], -1)
    return type(nodes)(nodes.vmin[order], nodes.vmax[order],
                       left.astype(np.int32),
                       np.where(inner, 0, nodes.leaf_start[order]),
                       nodes.leaf_count[order], nodes.perm)


@pytest.fixture(scope='module', params=['room', 'statue'])
def built(request):
    """The same scene through both packages' scene graphs."""
    def make(mod, proc):
        if request.param == 'room':
            return build_room(mod, add_cube)
        s = mod.Scene(asset_dirs=['.'])
        m = s.add_material(mod.Material.DIFFUSE((0.5, 0.5, 0.5)))
        proc.add_statue(s, m)
        s.add_object(mod.GameObject(0))
        add_cube(s, m)
        for x in (-4.0, 4.0):
            s.add_object(mod.GameObject(1, position=[x, 1.0, 0.0],
                                        rotation=[0.3, x, 0.0]))
        s.finalize()
        return s
    return make(js, jproc), make(ts, tproc)


def test_constants_equal():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


def test_native_builder_available_in_both():
    assert jnative.available() == tnative.available()


def test_build_bvh_and_thread_bvh(built):
    jscene, tscene = built
    _same(tscene._v0, jscene._v0, 'v0')
    _same(tscene._v1, jscene._v1, 'v1')
    _same(tscene._v2, jscene._v2, 'v2')
    for jm, tm in zip(jscene.models, tscene.models):
        s, c = tm.triangle_start, tm.nr_triangles
        tri = (tscene._v0[s:s + c], tscene._v1[s:s + c], tscene._v2[s:s + c])
        tn, jn = tbvh.build_bvh(*tri), jbvh.build_bvh(*tri)
        assert len(tn.vmin) == len(jn.vmin)
        _same_tuple(_canonical(tn), _canonical(jn), 'build_bvh')
        if c <= 2000:   # the numpy fallback is slow on the statue
            _same_tuple(tbvh.build_bvh_numpy(*tri),
                        jbvh.build_bvh_numpy(*tri), 'build_bvh_numpy')
        _same_tuple(tflat.thread_bvh(tn), jflat.thread_bvh(jn), 'thread_bvh')
        _same_tuple(tm.bvh, jm.bvh, 'model.bvh')
        _same_tuple(twide.build_wide_bvh(tn, *tri),
                    jwide.build_wide_bvh(jn, *tri), 'build_wide_bvh')
        _same_tuple(tm.wide, jm.wide, 'model.wide')


def test_world_tables(built):
    jscene, tscene = built
    transforms, _, _ = tscene.instances()
    inst_model = np.array([o.model_id for o in tscene.objects], np.int32)
    args = ([m.triangle_start for m in tscene.models],
            [m.nr_triangles for m in tscene.models],
            tscene._v0, tscene._v1, tscene._v2, inst_model, transforms)
    twb = ttop.build_world_bvh([m.bvh for m in tscene.models], *args)
    jwb = jtop.build_world_bvh([m.bvh for m in jscene.models], *args)
    _same_tuple(twb, jwb, 'build_world_bvh')
    bases = [int(b) for b in twb.wtri_base]
    tww = twide.build_world_wide([m.wide for m in tscene.models], inst_model,
                                 transforms, bases)
    jww = jwide.build_world_wide([m.wide for m in jscene.models], inst_model,
                                 transforms, bases)
    _same_tuple(tww, jww, 'build_world_wide')
    _same(ttp2.build_merged_table(tww.rows, tww.depth).rows,
          jtp2.build_merged_table(jww.rows, jww.depth).rows,
          'build_merged_table')
    tpt = ttp.split_packet_tables(tww.rows, tww.depth)
    jpt = jtp.split_packet_tables(jww.rows, jww.depth)
    _same(tpt.inner, jpt.inner, 'split inner')
    _same(tpt.leaf, jpt.leaf, 'split leaf')
    assert tpt.depth == jpt.depth


def test_objloader(tmp_path):
    (tmp_path / 'quad.obj').write_text(
        'mtllib quad.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n'
        'vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n'
        'usemtl red\nf 1/1/1 2/2/1 3/3/1 4/4/1\nf -4 -2 -1\n')
    (tmp_path / 'quad.mtl').write_text(
        'newmtl red\nKd 0.8 0.1 0.1\nKs 0.2 0.2 0.2\nNs 90\nNi 1.4\nd 0.5\n')
    t = tobj.load_obj(str(tmp_path / 'quad.obj'), [str(tmp_path)])
    j = jobj.load_obj(str(tmp_path / 'quad.obj'), [str(tmp_path)])
    for f in ('vertices', 'normals', 'texcoords', 'tri_v', 'tri_vt',
              'tri_vn', 'tri_mat'):
        _same(getattr(t, f), getattr(j, f), f)
    assert len(t.materials) == len(j.materials) == 1
    assert vars(t.materials[0]) == vars(j.materials[0])


def test_native_build_without_openmp(built, tmp_path, monkeypatch):
    """On a compiler that refuses ``-fopenmp`` (a host with no libgomp) the
    port's native builder compiles once more without it, and that serial
    build gives the OpenMP build's tree and the JAX package's."""
    jscene, tscene = built
    m = tscene.models[0]
    s, c = m.triangle_start, m.nr_triangles
    tri = (tscene._v0[s:s + c], tscene._v1[s:s + c], tscene._v2[s:s + c])
    assert '-fopenmp' in tnative.build_flags()
    with_openmp = _canonical(tbvh.build_bvh(*tri))
    want = _canonical(jbvh.build_bvh(*tri))

    cxx = tmp_path / 'g++'
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do\n  if [ "$a" = -fopenmp ]; '
                   'then echo "no libgomp.spec" >&2; exit 1; fi\ndone\n'
                   'exec g++ "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setenv('CXX', str(cxx))
    monkeypatch.delenv('CXXFLAGS', raising=False)
    monkeypatch.setattr(tnative, '_BUILD_DIR', str(tmp_path / 'build'))
    for name, value in (('_LIB', None), ('_TRIED', False), ('_FLAGS', None),
                        ('_LOG', None)):
        monkeypatch.setattr(tnative, name, value)
    assert tnative.available()
    assert tnative.build_flags() == [f for f in tnative.CXXFLAGS
                                     if f != '-fopenmp']
    log = tnative.build_log()
    assert log.count(f'{cxx} ') == 2 and 'no libgomp.spec' in log, log
    serial = _canonical(tbvh.build_bvh(*tri))
    _same_tuple(serial, with_openmp, 'serial vs OpenMP')
    _same_tuple(serial, want, 'serial vs JAX')
