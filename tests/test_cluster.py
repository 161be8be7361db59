"""Cluster granularity: per-stage jitted regions vs the oracle.

The reference re-runs every kernel under each cluster granularity
(tests/test-cluster.sh:5-66); this is the same gate for the XLA
executor, where ``coarse`` (and ``fine``) jit each stage separately and
hand every stage result over through device memory.
"""

import numpy as np
import pytest

from soda_tpu import corpus
from soda_tpu.backend import get_executor, reference
from soda_tpu.backend.xla import XlaExecutor

from checks import assert_close_reference


@pytest.mark.parametrize('name', ['blur', 'sobel2d', 'jacobi2d',
                                  'denoise2d', 'heat3d', 'xcorr'])
def test_coarse_cluster_matches_oracle(name):
  stencil = corpus.build(name, cluster='coarse')
  shape = corpus.TEST_DIMS[name]
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  want = reference.run(stencil, inputs, params)
  ex = get_executor(stencil, shape)
  assert isinstance(ex, XlaExecutor)
  assert len(ex.plan.groups) == len(ex.plan.stages)  # one jit per stage
  got = ex(inputs, params)
  for out in stencil.output_names:
    region = reference.output_valid_slices(stencil, shape, out)
    assert_close_reference(
        np.asarray(got[out])[region], want[out][region],
        stencil.symbol_table[out].is_float, f'{name}:coarse')


def test_fine_behaves_as_coarse():
  stencil = corpus.build('blur', cluster='fine')
  shape = corpus.TEST_DIMS['blur']
  ex = get_executor(stencil, shape)
  assert len(ex.plan.groups) == len(ex.plan.stages)
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  got = ex(inputs)
  region = reference.output_valid_slices(stencil, shape)
  assert np.array_equal(np.asarray(got['blur_y'])[region],
                        want['blur_y'][region])


def test_preserve_border_through_groups():
  stencil = corpus.build('jacobi2d', cluster='coarse', border='preserve')
  shape = corpus.TEST_DIMS['jacobi2d']
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  got = get_executor(stencil, shape)(inputs)
  # preserve defines every cell, including the border
  assert_close_reference(np.asarray(got['t0']), want['t0'], True,
                         'preserve:coarse')
