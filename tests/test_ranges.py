"""Value-range analysis (soda_tpu.optimization.ranges).

Interval arithmetic from the inputs' integer widths through every
stage: a stage whose computed range overflows its declared type gets
the full type range (the store wrap loses all information), one that
fits keeps its computed range, and an integer division whose operands
provably fit float32's mantissa is marked ``div_f32_ok``. Each case is
backed by a bit-exactness differential of the XLA executor against the
NumPy oracle with values that genuinely overflow the storage width, so
every stage's store wrap is exercised.
"""

import numpy as np

from soda_tpu import api
from soda_tpu.backend import reference
from soda_tpu.backend.xla import XlaExecutor
from soda_tpu.backend.reference import output_valid_slices
from soda_tpu.ir import nodes as ir
from soda_tpu.optimization import ranges

_HEADER = """
kernel: t
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
"""


def _build(body: str):
  stencil = api.build_stencil(_HEADER + body)
  ranges.annotate(stencil)
  return stencil


INT16 = (-(1 << 15), (1 << 15) - 1)
INT32 = (-(1 << 31), (1 << 31) - 1)


def _div_flags(stencil, name):
  """div_f32_ok flags of every MulDiv in ``name``'s expression, in
  tree order (read off the annotated nodes themselves)."""
  flags = []

  def walk(node):
    flags.extend(getattr(node, 'div_f32_ok', ()) or ())
    for attr in getattr(node, 'ATTRS', ()):
      val = getattr(node, attr)
      for v in val if isinstance(val, tuple) else (val,):
        if isinstance(v, ir.Node):
          walk(v)

  walk(stencil.tensors[name].expr)
  return flags


def _assert_bit_exact(stencil, shape=(32, 128)):
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  got = XlaExecutor(stencil, shape)(inputs)
  for name in stencil.output_names:
    region = output_valid_slices(stencil, shape, name)
    np.testing.assert_array_equal(
        np.asarray(want[name])[region], np.asarray(got[name])[region])


def test_sum_chain_wraps_sink():
  # both partial sums overflow int16: every stage's range is the full
  # type range, and the executor's per-stage wraps match the oracle
  st = _build("""
input dram 0 int16: x(128, *)
local int16: a(0, 0) = x(0, 0) + x(0, 1) + x(1, 0)
local int16: b(0, 0) = a(0, 0) + a(1, 1) + a(0, 2)
output dram 1 int16: y(0, 0) = b(0, 0) + b(1, 0)
""")
  table = ranges.annotate(st)
  assert table['a'] == table['b'] == table['y'] == INT16
  _assert_bit_exact(st)


def test_division_pins_producer():
  # b feeds a division: its wrapped value fits the f32 mantissa, so
  # the division is proven exact in float32
  st = _build("""
input dram 0 int16: x(128, *)
local int16: a(0, 0) = x(0, 0) + x(0, 1)
local int16: b(0, 0) = a(0, 0) + a(1, 0)
output dram 1 int16: y(0, 0) = b(0, 0) / 7
""")
  assert ranges.annotate(st)['b'] == INT16
  assert _div_flags(st, 'y') == [True]
  _assert_bit_exact(st)


def test_minmax_pins_producer():
  st = _build("""
input dram 0 int16: x(128, *)
local int16: a(0, 0) = x(0, 0) + x(0, 1)
output dram 1 int16: y(0, 0) = min(a(0, 0), a(1, 0))
""")
  table = ranges.annotate(st)
  assert table['a'] == table['y'] == INT16
  _assert_bit_exact(st)


def test_wider_downstream_wrap_blocks_sinking():
  # a:int16 consumed by an int32 stage: b's product of two int16
  # values fits int32 and keeps its computed range; y's sum does not
  st = _build("""
input dram 0 int16: x(128, *)
local int16: a(0, 0) = x(0, 0) + x(0, 1)
local int32: b(0, 0) = int32(a(0, 0)) * int32(a(1, 0))
output dram 1 int32: y(0, 0) = b(0, 0) + b(1, 0)
""")
  table = ranges.annotate(st)
  assert table['a'] == INT16
  assert table['b'] == (INT16[0] * INT16[1], INT16[0] * INT16[0])
  assert table['y'] == INT32
  _assert_bit_exact(st)


def test_sink_through_narrowing_cast():
  # the int16 cast inside z's expr wraps to int16 itself, so z keeps
  # the int16 range even though it is stored at int32
  st = _build("""
input dram 0 int16: x(128, *)
local int16: a(0, 0) = x(0, 0) + x(0, 1)
output dram 1 int32: z(0, 0) = int32(int16(a(0, 0) + a(1, 0)))
""")
  assert ranges.annotate(st)['z'] == INT16
  _assert_bit_exact(st)


def test_range_elided_consumer_blocks_sinking_when_feeding_division():
  # b's range fits int16 (a/8 + a/8 stays in range), so it keeps its
  # computed range; a overflows and must wrap before the divisions
  st = _build("""
input dram 0 int16: x(128, *)
local int16: a(0, 0) = x(0, 0) + x(0, 1)
local int16: b(0, 0) = a(0, 0) / 8 + a(1, 0) / 8
output dram 1 int16: y(0, 0) = b(0, 0) / 3
""")
  table = ranges.annotate(st)
  assert table['a'] == INT16
  assert INT16[0] < table['b'][0] and table['b'][1] < INT16[1]
  assert _div_flags(st, 'b') == [True, True]
  assert _div_flags(st, 'y') == [True]
  _assert_bit_exact(st)


def test_unsigned_sum_chain_sinks():
  st = _build("""
input dram 0 uint16: x(128, *)
local uint16: a(0, 0) = x(0, 0) + x(0, 1) + x(0, 2)
output dram 1 uint16: y(0, 0) = a(0, 0) + a(1, 0) + a(2, 0)
""")
  table = ranges.annotate(st)
  assert table['a'] == table['y'] == (0, (1 << 16) - 1)
  _assert_bit_exact(st)


def test_paren_wrapper_range_passes_through():
  # a single-operand chain wrapper (parenthesized subexpression) is
  # not a comparison: its range must not collapse to (0, 1). y's
  # dividend exceeds the f32 mantissa bound, so the exact-f32 division
  # fast path must NOT be proven
  st = _build("""
input dram 0 int32: x(128, *)
output dram 1 int32: y(0, 0) = (x(0, 0) * x(0, 1)) / 3
""")
  table = ranges.annotate(st)
  assert table['y'][1] > 1  # not the (0, 1) comparison range
  assert _div_flags(st, 'y') == [False, False]  # '*', then '/'


def test_mul_chain_sinks_through_multiplication():
  # overflowing products wrap at every stage and match the oracle
  st = _build("""
input dram 0 int16: x(128, *)
local int16: a(0, 0) = x(0, 0) * x(0, 1)
output dram 1 int16: y(0, 0) = a(0, 0) * a(1, 0) + a(0, 1)
""")
  table = ranges.annotate(st)
  assert table['a'] == table['y'] == INT16
  _assert_bit_exact(st)
