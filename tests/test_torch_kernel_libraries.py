"""The two CUDA libraries' build keys, on the CPU (no ``nvcc``: a library's
path only hashes its sources). The renderer's library holds the render
kernels alone; the probe kernels of ``tools/csrc/`` build into their own,
whose key also covers the render header they include."""
import os
import re
import shutil

import pytest

from cuda_pathtracer_tpu_torch.ops import kernels
from cuda_pathtracer_tpu_torch.tools import probe_kernels

RENDER_SOURCES = {'traverse.cu', 'traverse_packet.cu', 'guiding_scatter.cu',
                  'blur.cu', 'whitted_shade.cu', 'whitted_lanes.cu',
                  'traverse_common.cuh'}
INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)


def _names(paths):
    return {os.path.basename(p) for p in paths}


def _copy_trees(tmp_path):
    """The two source trees copied as the package lays them out, so the
    probe header's relative include still reaches the render header."""
    render = tmp_path / 'pkg' / 'csrc'
    probes = tmp_path / 'pkg' / 'tools' / 'csrc'
    shutil.copytree(kernels.CSRC, render)
    shutil.copytree(probe_kernels.CSRC, probes)
    return str(render), str(probes)


def _paths(render, probes, build):
    return (kernels.library_path(render, build),
            probe_kernels.library_path(probes, render, build))


def test_render_library_holds_only_the_render_kernels():
    assert _names(kernels.sources()) == RENDER_SOURCES
    assert set(kernels.NAMES) == {'traverse', 'prepass', 'traverse_packet',
                                  'guiding_scatter', 'blur', 'whitted_shade',
                                  'whitted_lanes'}
    assert set(kernels.LAUNCHES) == set(kernels.NAMES) | {
        'whitted_sort_block', 'whitted_sort_library'}
    assert not [n for n in kernels.NAMES if 'probe' in n]
    assert not [n for n in kernels._SIGNATURES if 'probe' in n]
    assert os.path.basename(kernels.library_path()).startswith(
        'libcpt_kernels_')


def test_probe_library_holds_the_probe_kernels():
    names = _names(kernels.sources(probe_kernels.CSRC))
    assert len([n for n in names if n.endswith('.cu')]) == 9
    assert all(n.startswith('probe_') for n in names)
    assert len(probe_kernels.NAMES) == 8
    assert all(f'cpt_{n}' in probe_kernels._SIGNATURES
               for n in probe_kernels.NAMES)
    assert 'cpt_probe_error_string' in probe_kernels._SIGNATURES
    assert not set(probe_kernels._SIGNATURES) & set(kernels._SIGNATURES)
    assert os.path.basename(probe_kernels.library_path()).startswith(
        'libcpt_probes_')


@pytest.mark.parametrize('src_dir,headers', [
    (kernels.CSRC, ()),
    (probe_kernels.CSRC,
     tuple(os.path.join(kernels.CSRC, h) for h in probe_kernels.SHARED))],
    ids=['render', 'probes'])
def test_every_include_is_in_the_key(src_dir, headers):
    """A quoted include resolves to a file the library's key hashes."""
    hashed = {os.path.realpath(p) for p in kernels.sources(src_dir, headers)}
    for src in kernels.sources(src_dir):
        with open(src) as f:
            for inc in INCLUDE.findall(f.read()):
                path = os.path.realpath(os.path.join(src_dir, inc))
                assert os.path.exists(path), (src, inc)
                assert path in hashed, (src, inc)


def test_editing_a_probe_leaves_the_render_library(tmp_path):
    render, probes = _copy_trees(tmp_path)
    build = str(tmp_path / 'build')
    r0, p0 = _paths(render, probes, build)
    with open(os.path.join(probes, 'probe_gather.cu'), 'a') as f:
        f.write('// edited\n')
    r1, p1 = _paths(render, probes, build)
    assert r1 == r0
    assert p1 != p0


def test_editing_the_shared_header_rebuilds_both(tmp_path):
    render, probes = _copy_trees(tmp_path)
    build = str(tmp_path / 'build')
    r0, p0 = _paths(render, probes, build)
    with open(os.path.join(render, 'traverse_common.cuh'), 'a') as f:
        f.write('// edited\n')
    r1, p1 = _paths(render, probes, build)
    assert r1 != r0
    assert p1 != p0
