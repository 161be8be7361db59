"""Coarse-grain replication: R independent grids per launch.

The reference's `replication factor` duplicates the pipeline
(core.py:565-614); here R grids batch through one vmapped kernel, and
a mesh shards the batch (data parallelism).
"""

import numpy as np
import pytest

import jax

from soda_tpu import corpus
from soda_tpu.backend import reference
from soda_tpu.parallel.replicate import ReplicatedExecutor

from checks import assert_close_reference


def _batched_inputs(stencil, shape, r):
  batches = []
  for k in range(r):
    batches.append(reference.make_test_inputs(stencil, shape, seed=k))
  return {
      name: np.stack([b[name] for b in batches])
      for name in stencil.input_names
  }, batches


@pytest.mark.parametrize('name', ['blur', 'jacobi2d', 'heat3d'])
def test_replicated_matches_oracle(name):
  stencil = corpus.build(name, replication_factor=4)
  shape = corpus.TEST_DIMS[name]
  inputs, per_grid = _batched_inputs(stencil, shape, 4)
  ex = ReplicatedExecutor(stencil, shape)
  assert ex.replication_factor == 4
  got = ex(inputs)
  for k in range(4):
    want = reference.run(stencil, per_grid[k])
    for out in stencil.output_names:
      region = reference.output_valid_slices(stencil, shape, out)
      assert_close_reference(
          np.asarray(got[out])[k][region], want[out][region],
          stencil.symbol_table[out].is_float, f'{name}:replica{k}')


def test_replicated_over_mesh():
  from jax.sharding import Mesh
  mesh = Mesh(np.array(jax.devices()), ('r',))
  stencil = corpus.build('jacobi2d')
  shape = corpus.TEST_DIMS['jacobi2d']
  inputs, per_grid = _batched_inputs(stencil, shape, 8)
  ex = ReplicatedExecutor(stencil, shape, replication_factor=8,
                          mesh=mesh)
  got = ex(inputs)
  want0 = reference.run(stencil, per_grid[0])
  region = reference.output_valid_slices(stencil, shape)
  assert_close_reference(np.asarray(got['t0'])[0][region],
                         want0['t0'][region], True, 'mesh-replica')


def test_replication_factor_validation():
  import pytest as _pytest
  from soda_tpu import utils
  stencil = corpus.build('blur')
  with _pytest.raises(utils.InputError):
    ReplicatedExecutor(stencil, corpus.TEST_DIMS['blur'],
                       replication_factor=0)


def test_replicated_xla_inner_backend():
  """The inner XlaExecutor takes the executor's keyword options: with
  ``cluster='coarse'`` (one jit per stage) the vmapped batch still
  matches the oracle."""
  from soda_tpu.backend.xla import XlaExecutor
  stencil = corpus.build('blur', replication_factor=2)
  shape = corpus.TEST_DIMS['blur']
  inputs, per_grid = _batched_inputs(stencil, shape, 2)
  ex = ReplicatedExecutor(stencil, shape, cluster='coarse')
  assert isinstance(ex.inner, XlaExecutor)
  assert len(ex.inner.plan.groups) > 1
  got = ex(inputs)
  for k in range(2):
    want = reference.run(stencil, per_grid[k])
    for out in stencil.output_names:
      region = reference.output_valid_slices(stencil, shape, out)
      assert_close_reference(np.asarray(got[out])[k][region],
                             want[out][region], False, 'xla-inner')


def test_replicated_2d_mesh_partitions_first_axis():
  # factor divisible by the FIRST mesh axis, not the whole mesh
  from jax.sharding import Mesh
  stencil = corpus.build('blur', replication_factor=2)
  shape = corpus.TEST_DIMS['blur']
  devices = np.array(jax.devices()[:8]).reshape(2, 4)
  mesh = Mesh(devices, ('x', 'y'))
  inputs, per_grid = _batched_inputs(stencil, shape, 2)
  ex = ReplicatedExecutor(stencil, shape, mesh=mesh)
  got = ex(inputs)
  want = reference.run(stencil, per_grid[0])
  region = reference.output_valid_slices(stencil, shape)
  assert_close_reference(np.asarray(got['blur_y'])[0][region],
                         want['blur_y'][region], False, '2d-mesh')
