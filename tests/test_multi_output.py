"""Multiple output statements through every executor (the reference
supports multi-in/multi-out kernels; iterate>1 even requires matched
input/output lists)."""

import numpy as np
import pytest

from soda_tpu.api import build_stencil
from soda_tpu.backend import reference
from soda_tpu.backend.xla import XlaExecutor
from soda_tpu.parallel.spmd import ShardedExecutor

from checks import assert_close_reference, xla_coarse

TWO_OUT = '''
kernel: gradients
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 float: img(64, *)
local float: blur(0, 0) =
  (img(-1, 0) + img(0, 0) + img(1, 0)) * .3333333f
output dram 1 float: gx(0, 0) = blur(1, 0) - blur(-1, 0)
output dram 2 float: gy(0, 0) = blur(0, 1) - blur(0, -1)
'''

TWO_IN_TWO_OUT_ITER = '''
kernel: twofield
burst width: 64
unroll factor: 1
iterate: 2
border: ignore
cluster: none
input dram 0 float: u(64, *)
input dram 1 float: v(64, *)
output dram 0 float: un(0, 0) =
  (u(0, 0) + u(1, 0) + u(-1, 0)) * .25f + v(0, 0) * .25f
output dram 1 float: vn(0, 0) =
  (v(0, 0) + v(0, 1) + v(0, -1)) * .25f + u(0, 0) * .25f
'''

SHAPE = (24, 64)


@pytest.mark.parametrize('program', [TWO_OUT, TWO_IN_TWO_OUT_ITER],
                         ids=['two-out', 'two-in-two-out-iterate2'])
@pytest.mark.parametrize('executor_cls', [XlaExecutor, xla_coarse])
def test_multi_output(program, executor_cls):
  stencil = build_stencil(program)
  inputs = reference.make_test_inputs(stencil, SHAPE)
  want = reference.run(stencil, inputs)
  got = executor_cls(stencil, SHAPE)(inputs)
  assert set(got) == set(stencil.output_names)
  for name in stencil.output_names:
    region = reference.output_valid_slices(stencil, SHAPE, name)
    assert_close_reference(np.asarray(got[name])[region],
                           want[name][region], True, name)


@pytest.mark.parametrize('mesh_shape', [(8,), (4, 2), (2, 4)],
                         ids=['mesh8', 'mesh4x2', 'mesh2x4'])
def test_multi_output_sharded_meshes(mesh_shape):
  """A shared local feeding two outputs over 1-D and 2-D meshes: every
  output is cropped and stitched from its own shard extents."""
  import jax
  from jax.sharding import Mesh
  stencil = build_stencil(TWO_OUT)
  shape = (64, 64)
  devices = np.array(jax.devices()[:int(np.prod(mesh_shape))])
  mesh = Mesh(devices.reshape(mesh_shape), tuple('xy'[:len(mesh_shape)]))
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  got = ShardedExecutor(stencil, shape, mesh=mesh)(inputs)
  for name in stencil.output_names:
    region = reference.output_valid_slices(stencil, shape, name)
    assert_close_reference(np.asarray(got[name])[region],
                           want[name][region], True, name)


def test_multi_output_sharded():
  stencil = build_stencil(TWO_IN_TWO_OUT_ITER)
  shape = (64, 64)
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  got = ShardedExecutor(stencil, shape)(inputs)
  for name in stencil.output_names:
    region = reference.output_valid_slices(stencil, shape, name)
    assert_close_reference(np.asarray(got[name])[region],
                           want[name][region], True, name)
