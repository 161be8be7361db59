"""border: preserve semantics across executors.

The reference reserves this directive without implementing it
(core.py:30 "Reserved"); here boundary cells keep the positionally
paired input's values — the natural Dirichlet-boundary semantics for
iterative stencils.
"""

import numpy as np
import pytest

from soda_tpu import corpus
from soda_tpu.backend import reference
from soda_tpu.backend.xla import XlaExecutor

from checks import assert_close_reference, xla_coarse


def build_preserve(name):
  return corpus.build(name, border='preserve')


@pytest.mark.parametrize('name', ['blur', 'jacobi2d', 'seidel2d'])
def test_oracle_preserves_borders(name):
  stencil = build_preserve(name)
  shape = corpus.TEST_DIMS[name]
  inputs = reference.make_test_inputs(stencil, shape)
  outs = reference.run(stencil, inputs)
  out_name = stencil.output_names[0]
  in_name = stencil.input_names[0]
  region = reference.output_valid_slices(stencil, shape, out_name)
  got = outs[out_name]
  # borders == input, interior == the plain (ignore) result
  mask = np.zeros(shape, bool)
  mask[region] = True
  from soda_tpu.backend import semantics
  want_border = semantics.wrap(
      np, inputs[in_name], stencil.symbol_table[out_name])
  np.testing.assert_array_equal(got[~mask], want_border[~mask])
  plain = corpus.build(name)
  want = reference.run(plain, inputs)[out_name]
  assert_close_reference(got[region], want[region],
                         stencil.symbol_table[out_name].is_float, name)


@pytest.mark.parametrize('executor_cls', [XlaExecutor, xla_coarse])
@pytest.mark.parametrize('name', ['blur', 'jacobi2d'])
def test_backends_match_oracle_with_preserve(name, executor_cls):
  stencil = build_preserve(name)
  shape = corpus.TEST_DIMS[name]
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  ex = executor_cls(stencil, shape)
  got = ex(inputs)
  for out_name in stencil.output_names:
    # full-array comparison: preserve defines every cell
    assert_close_reference(
        np.asarray(got[out_name]), want[out_name],
        stencil.symbol_table[out_name].is_float, f'{name}:preserve')


def test_preserve_through_chained_steps():
  """Chained applications keep the boundary fixed: the paired input's
  border cells survive every step (Dirichlet boundary)."""
  import soda_tpu
  stencil = build_preserve('jacobi2d')
  shape = corpus.TEST_DIMS['jacobi2d']
  inputs = reference.make_test_inputs(stencil, shape)
  want = dict(inputs)
  for _ in range(3):
    want = {'t1': reference.run(stencil, want)['t0']}
  ex = XlaExecutor(stencil, shape)
  (got,) = soda_tpu.chained(ex, 3)(*ex.prepare(inputs))
  assert_close_reference(np.asarray(got), want['t1'], True,
                         'preserve-chained')
