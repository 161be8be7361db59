"""Kernel parameters (``param`` statements) through every executor.

The reference supports scalar/array kernel parameters with dup /
partition attributes (grammar.py:153-171); here they become extra
device arrays indexed at constant offsets inside the jitted stages.
"""

import numpy as np
import pytest

from soda_tpu.api import build_stencil
from soda_tpu.backend import reference
from soda_tpu.backend.xla import XlaExecutor
from soda_tpu.codegen import jax_source

from checks import assert_close_reference, xla_coarse

CONV_PARAM = '''
kernel: wconv
burst width: 64
unroll factor: 2
iterate: 1
border: ignore
cluster: none
param float, dup 2, partition complete: w[3][3]
input dram 0 float: img(64, *)
output dram 1 float: out(0, 0) =
  img(-1, -1) * w(0, 0) + img(0, -1) * w(1, 0) + img(1, -1) * w(2, 0) +
  img(-1, 0) * w(0, 1) + img(0, 0) * w(1, 1) + img(1, 0) * w(2, 1) +
  img(-1, 1) * w(0, 2) + img(0, 1) * w(1, 2) + img(1, 1) * w(2, 2)
'''

SHAPE = (24, 64)


def setup():
  stencil = build_stencil(CONV_PARAM)
  inputs = reference.make_test_inputs(stencil, SHAPE)
  params = reference.make_test_params(stencil)
  want = reference.run(stencil, inputs, params)
  return stencil, inputs, params, want


def test_param_parses_and_runs_oracle():
  stencil, inputs, params, want = setup()
  assert stencil.param_names == ('w',)
  # oracle vs a direct correlate
  img = inputs['img']
  w = params['w']
  out = np.zeros(SHAPE, np.float32)
  for dy in range(3):
    for dx in range(3):
      out[1:-1, 1:-1] += (img[dy:SHAPE[0] - 2 + dy, dx:SHAPE[1] - 2 + dx] *
                          w[dx, dy])
  region = reference.output_valid_slices(stencil, SHAPE)
  np.testing.assert_allclose(want['out'][region], out[region], rtol=2e-5,
                             atol=2e-5)


@pytest.mark.parametrize('executor_cls', [XlaExecutor, xla_coarse])
def test_param_backends_match_oracle(executor_cls):
  stencil, inputs, params, want = setup()
  got = executor_cls(stencil, SHAPE)(inputs, params)
  region = reference.output_valid_slices(stencil, SHAPE)
  assert_close_reference(np.asarray(got['out'])[region],
                         want['out'][region], True, 'param')


def test_param_codegen_matches_oracle():
  stencil, inputs, params, want = setup()
  import types
  src = jax_source.generate(stencil, SHAPE)
  module = types.ModuleType('g')
  exec(compile(src, '<g>', 'exec'), module.__dict__)
  got = module.compute(inputs['img'], params['w'])
  region = reference.output_valid_slices(stencil, SHAPE)
  assert_close_reference(np.asarray(got['out'])[region],
                         want['out'][region], True, 'param-codegen')
