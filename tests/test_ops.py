"""Operator coverage beyond the corpus: %, select, comparisons,
bitwise ops, unary minus/not — oracle vs the XLA executor, fused and
per-stage."""

import numpy as np
import pytest

from soda_tpu.api import build_stencil
from soda_tpu.backend import reference
from soda_tpu.backend.xla import XlaExecutor

from checks import assert_close_reference, xla_coarse

HEADER = '''
kernel: ops
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 int16: x(64, *)
'''

SHAPE = (24, 64)

PROGRAMS = {
    'modulo': HEADER + '''
output dram 1 int16: y(0, 0) = (x(0, 0) * x(1, 0) - x(0, 1)) % 7
''',
    'select': HEADER + '''
output dram 1 int16: y(0, 0) = select(x(0, 0) > x(1, 1), x(0, 0), x(1, 1))
''',
    'bitwise': HEADER + '''
output dram 1 int16: y(0, 0) = ((x(0, 0) & 255) | (x(1, 0) ^ 15)) + ~x(0, 1)
''',
    'compare_logic': HEADER + '''
output dram 1 int16: y(0, 0) =
  select(x(0, 0) >= x(1, 0) && !(x(0, 1) == x(1, 1)), 1, 0) + x(0, 0)
''',
    'unary_minus': HEADER + '''
output dram 1 int16: y(0, 0) = -x(1, 0) + x(0, 1) * -2
''',
    'nested_let': HEADER + '''
output dram 1 int16:
  int32 a = x(0, 0) + x(1, 0)
  int32 b = a * a
  y(0, 0) = int16(b % 1000) + x(0, 1)
''',
}


@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_op_coverage(name):
  stencil = build_stencil(PROGRAMS[name])
  inputs = reference.make_test_inputs(stencil, SHAPE)
  want = reference.run(stencil, inputs)
  region = reference.output_valid_slices(stencil, SHAPE)
  for cls in (XlaExecutor, xla_coarse):
    got = cls(stencil, SHAPE)(inputs)
    assert_close_reference(
        np.asarray(got['y'])[region], want['y'][region], False,
        '%s/%s' % (name, cls.__name__))


def test_modulo_matches_c_semantics():
  # negative dividends: C remainder keeps the dividend's sign
  stencil = build_stencil(PROGRAMS['modulo'])
  inputs = {'x': (np.arange(24 * 64, dtype=np.int16).reshape(SHAPE)
                  - 700)}
  want = reference.run(stencil, inputs)
  x = inputs['x'].astype(np.int32)
  # x(1, 0): +1 in DSL dim 0 = minor axis; x(0, 1): +1 in streaming axis
  num = x[:-1, :-1] * x[:-1, 1:] - x[1:, :-1]
  expect = (num - np.fix(num / 7) * 7).astype(np.int16)
  region = reference.output_valid_slices(stencil, SHAPE)
  np.testing.assert_array_equal(want['y'][region], expect)
