"""Backend dispatch: 'auto' builds the XLA executor on every platform;
the retired fused-kernel backend and its options are clear errors."""

import numpy as np
import pytest

from soda_tpu import corpus, utils
from soda_tpu.backend import RETIRED_KERNEL_OPTIONS, get_executor, reference
from soda_tpu.backend.xla import XlaExecutor
from soda_tpu.parallel.replicate import ReplicatedExecutor
from soda_tpu.parallel.spmd import ShardedExecutor

from checks import assert_close_reference


@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_auto_builds_xla(name):
  stencil = corpus.build(name)
  ex = get_executor(stencil, corpus.TEST_DIMS[name])
  assert isinstance(ex, XlaExecutor)
  assert len(ex.plan.groups) == 1  # cluster: none -> one jitted region


def test_pallas_backend_is_an_error():
  stencil = corpus.build('jacobi2d')
  with pytest.raises(utils.InputError, match='removed'):
    get_executor(stencil, (24, 32), 'pallas')


@pytest.mark.parametrize('option', sorted(RETIRED_KERNEL_OPTIONS))
@pytest.mark.parametrize('backend', ['auto', 'xla'])
def test_fused_kernel_options_are_errors(option, backend):
  stencil = corpus.build('jacobi2d')
  with pytest.raises(utils.InputError, match=option):
    get_executor(stencil, (24, 32), backend, **{option: 8})


def test_sharded_and_replicated_dispatch():
  stencil = corpus.build('jacobi2d', replication_factor=2)
  assert isinstance(get_executor(stencil, (64, 32), 'sharded'),
                    ShardedExecutor)
  assert isinstance(get_executor(stencil, (24, 32), 'replicated'),
                    ReplicatedExecutor)


def test_unknown_backend_raises():
  with pytest.raises(ValueError, match='unknown backend'):
    get_executor(corpus.build('blur'), (40, 64), 'fpga')


def test_large_cross_section_runs_whole_grid():
  """A 3-D cross-section far wider than any on-chip buffer runs as one
  whole-grid XLA computation (no mid-axis tiling)."""
  stencil = corpus.build('jacobi3d')
  shape = (6, 160, 192)
  ex = get_executor(stencil, shape)
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  got = ex(inputs)
  region = reference.output_valid_slices(stencil, shape)
  assert_close_reference(np.asarray(got['t0'])[region],
                         want['t0'][region], True, 'jacobi3d:wide')
