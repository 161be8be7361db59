"""XLA executor vs the NumPy oracle at the edges of its contract.

The corpus at the smallest legal grid (one valid cell per axis) and at
minor-axis widths no tiling favours, 3-D cross-sections far wider than
the streaming extent, iterate up to 4, border: preserve and computation
reuse — each fused into one jitted region and split per stage (cluster:
coarse). Integer results are bit-exact, floats within the reference
THRESHOLD (checks.assert_close_reference).
"""

import numpy as np
import pytest

from soda_tpu import corpus, utils
from soda_tpu.backend import plan as plan_mod
from soda_tpu.backend import reference
from soda_tpu.backend.xla import XlaExecutor

from checks import assert_close_reference

CLUSTERS = ['none', 'coarse']


def min_shape(stencil):
  """Smallest grid validate_grid accepts: one valid cell per axis."""
  dim = len(stencil.tile_size)
  need = [1] * dim
  for lo, hi in plan_mod.materialized_margins(stencil).values():
    for d in range(dim):
      need[dim - 1 - d] = max(need[dim - 1 - d], lo[d] + hi[d] + 1)
  return tuple(need)


def check(stencil, shape, cluster, context, params=None):
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil) if params is None else params
  want = reference.run(stencil, inputs, params)
  got = XlaExecutor(stencil, shape, cluster=cluster)(inputs, params)
  for out in stencil.output_names:
    if stencil.preserve_border:
      region = tuple(slice(None) for _ in shape)
    else:
      region = reference.output_valid_slices(stencil, shape, out)
    assert_close_reference(
        np.asarray(got[out])[region], np.asarray(want[out])[region],
        stencil.symbol_table[out].is_float, '%s:%s' % (context, out))


@pytest.mark.parametrize('cluster', CLUSTERS)
@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_corpus_at_halo_limit(name, cluster):
  stencil = corpus.build(name)
  shape = min_shape(stencil)
  plan_mod.validate_grid(stencil, shape)
  region = reference.output_valid_slices(stencil, shape)
  assert all(s.stop - s.start == 1 for s in region), region
  check(stencil, shape, cluster, name)


@pytest.mark.parametrize('cluster', CLUSTERS)
@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_corpus_odd_minor_width(name, cluster):
  """Minor-axis widths that are neither powers of two nor multiples of
  any vector width."""
  stencil = corpus.build(name)
  rows = corpus.TEST_DIMS[name][0]
  shape = (rows, 29, 37) if stencil.dim == 3 else (rows, 37)
  check(stencil, shape, cluster, name)


@pytest.mark.parametrize('name,shape', [
    ('heat3d', (6, 96, 136)),
    ('jacobi3d', (6, 120, 72)),
    ('denoise3d', (6, 72, 104)),
])
def test_wide_3d_cross_section(name, shape):
  check(corpus.build(name), shape, 'none', name)


@pytest.mark.parametrize('iterate', [1, 2, 3, 4])
@pytest.mark.parametrize('name', ['jacobi2d', 'seidel2d', 'heat3d',
                                  'jacobi3d'])
def test_iterate_depth(name, iterate):
  stencil = corpus.build(name, iterate=iterate)
  plan = plan_mod.make_plan(stencil)
  base = plan_mod.make_plan(corpus.build(name, iterate=1))
  assert len(plan.stages) == iterate * len(base.stages)
  # the overall halo grows linearly with the number of fused sweeps
  assert plan.halo_lo == tuple(iterate * h for h in base.halo_lo)
  check(stencil, corpus.TEST_DIMS[name], 'none', '%s:it%d' % (name,
                                                              iterate))


@pytest.mark.parametrize('cluster', CLUSTERS)
@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_corpus_preserve_border(name, cluster):
  """border: preserve defines every cell: the whole grid is compared."""
  stencil = corpus.build(name, border='preserve')
  check(stencil, corpus.TEST_DIMS[name], cluster, name)


@pytest.mark.parametrize('cluster', CLUSTERS)
@pytest.mark.parametrize('name', ['erosion', 'xcorr', 'sobel2d', 'blur'])
def test_computation_reuse(name, cluster):
  stencil = corpus.build(name, optimizations={'computation-reuse': 'greedy'})
  check(stencil, corpus.TEST_DIMS[name], cluster, name)


def test_missing_input_param_and_wrong_shape_raise():
  from soda_tpu import api
  st = api.build_stencil('''
kernel: t
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
param float: k[1]
input dram 0 float: x(128, *)
output dram 1 float: y(0, 0) = x(0, 0) * k[0]
''')
  shape = (16, 128)
  ex = XlaExecutor(st, shape)
  inputs = reference.make_test_inputs(st, shape)
  with pytest.raises(utils.InputError, match='missing param'):
    ex(inputs, params={})
  with pytest.raises(utils.InputError, match='missing input'):
    ex({}, params={'k': np.ones(1, np.float32)})
  with pytest.raises(utils.InputError, match='compiled shape'):
    ex({'x': np.zeros((8, 128), np.float32)},
       params={'k': np.ones(1, np.float32)})
