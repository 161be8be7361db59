"""C-semantics evaluator unit tests: promotion, truncating division,
wrap-around — the exact rules the generated hosts rely on."""

import numpy as np
import pytest

from soda_tpu.backend import semantics
from soda_tpu.ir.types import Type


def test_promotion_sub_int_widths():
  assert semantics.promote(Type('uint16')) == Type('int32')  # C: -> int
  assert semantics.promote(Type('int8')) == Type('int32')
  assert semantics.promote(Type('uint32')) == Type('uint32')
  assert semantics.promote(Type('int64')) == Type('int64')
  assert semantics.promote(Type('float')) == Type('float')


def test_binary_type_unsigned_wins_at_equal_rank():
  assert semantics.binary_type(Type('uint32'), Type('int32')) == \
      Type('uint32')
  assert semantics.binary_type(Type('uint16'), Type('int16')) == \
      Type('int32')  # both promote to int first
  assert semantics.binary_type(Type('float'), Type('int32')) == \
      Type('float')
  assert semantics.binary_type(Type('float'), Type('double')) == \
      Type('double')


def test_c_int_div_truncates_toward_zero():
  a = np.array([7, -7, 7, -7, 6, -6], np.int32)
  b = np.array([2, 2, -2, -2, 3, 3], np.int32)
  got = semantics.c_int_div(np, a, b)
  np.testing.assert_array_equal(got, [3, -3, -3, 3, 2, -2])


def test_c_int_mod_sign_of_dividend():
  a = np.array([7, -7, 7, -7], np.int32)
  b = np.array([3, 3, -3, -3], np.int32)
  got = semantics.c_int_mod(np, a, b)
  np.testing.assert_array_equal(got, [1, -1, 1, -1])


def test_wrap_nonstandard_width():
  t = Type('uint6')
  got = semantics.wrap(np, np.array([63, 64, 65, 130]), t)
  np.testing.assert_array_equal(got, [63, 0, 1, 2])
  t = Type('int6')  # [-32, 31] wrap
  got = semantics.wrap(np, np.array([31, 32, -33]), t)
  np.testing.assert_array_equal(got, [31, -32, 31])


def test_wrap_float_to_int_truncates():
  got = semantics.wrap(np, np.array([1.9, -1.9]), Type('int32'))
  np.testing.assert_array_equal(got, [1, -1])


def test_fast_int_div_matches_exact():
  # differential check of the f32 strength reduction on the full
  # provable range boundary
  rng = np.random.default_rng(0)
  n = rng.integers(-(1 << 23) + 1, (1 << 23) - 1, size=20000)
  for d in (3, 7, 255, 1000):
    exact = semantics.c_int_div(np, n, np.int64(d))
    via_f32 = (n.astype(np.float32) / np.float32(d)).astype(np.int64)
    np.testing.assert_array_equal(via_f32, exact, err_msg='d=%d' % d)


@pytest.mark.parametrize('tname', ['int16', 'uint16', 'int8', 'uint8',
                                   'int32', 'uint32', 'int12', 'uint3'])
def test_jnp_store_wrap_matches_numpy(tname):
  """Stage stores wrap with C semantics under jax.numpy exactly as
  under NumPy (the oracle), including non-power-of-two widths and the
  extremes of the promoted range."""
  import jax.numpy as jnp
  from soda_tpu.backend.semantics import promote, wrap
  from soda_tpu.ir.types import Type
  dtype = Type(tname)
  rng = np.random.default_rng(7)
  v = rng.integers(-2**31, 2**31 - 1, 256, dtype=np.int64)
  v = np.concatenate([v, [0, 1, -1, 2**31 - 1, -2**31]])
  compute = v.astype(promote(dtype).np_dtype)  # what a stage yields
  want = wrap(np, compute, dtype)
  got = np.asarray(wrap(jnp, jnp.asarray(compute), dtype))
  assert got.dtype == want.dtype
  np.testing.assert_array_equal(got, want, err_msg=tname)


def test_pow2_div_shift_matches_c_division():
  """fast_int_div's 2^k shift path must equal C truncating division for
  all sign combinations (oracle keeps c_int_div, so executors verify
  this differentially end to end; this is the direct unit check)."""
  import numpy as np
  from soda_tpu import api
  from soda_tpu.backend.semantics import Evaluator, c_int_div
  from soda_tpu.ir import nodes as ir
  from soda_tpu.ir.types import Type

  rng = np.random.default_rng(0)
  vals = np.concatenate([
      rng.integers(-2**31, 2**31 - 1, 1000, dtype=np.int64),
      np.array([0, 1, -1, 255, -255, 256, -256, 2**31 - 1, -2**31]),
  ]).astype(np.int32)
  for k in (1, 8, 16):
    expr = api.build_stencil("""
kernel: t
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 int32: x(128, *)
output dram 1 int32: y(0, 0) = x(0, 0) / %d
""" % (1 << k)).output_stmts[0].expr
    ev = Evaluator(np, lambda ref: vals, fast_int_div=True)
    got, _ = ev.eval(expr)
    want = c_int_div(np, vals, np.int32(1 << k))
    np.testing.assert_array_equal(got, want)


def test_unary_minus_promotes_unsigned_operand():
  """C promotes before unary minus (C11 §6.5.3.3): -uint16(1) is
  -(int)1 == -1 — identical across the oracle and the XLA executor."""
  import numpy as np
  from soda_tpu import api
  from soda_tpu.backend import reference
  from soda_tpu.backend.xla import XlaExecutor

  src = """
kernel: t
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 uint16: a(128, *)
output dram 1 int32: o(0, 0) = (-a(0, 0)) / 2
"""
  st = api.build_stencil(src)
  shape = (16, 128)
  ins = {'a': np.full(shape, 1, np.uint16)}
  want = reference.run(st, ins)
  assert int(np.asarray(want['o'])[0, 0]) == 0  # -1 / 2 truncates to 0
  got = XlaExecutor(st, shape)(ins)
  region = reference.output_valid_slices(st, shape, 'o')
  np.testing.assert_array_equal(np.asarray(got['o'])[region],
                                np.asarray(want['o'])[region])


def test_half_is_storage_only_and_bit_exact_across_executors():
  """half arithmetic runs at float32 and rounds to f16 at stage
  stores. All executors share the rule via the Evaluator, so results
  are bit-identical, fused or per stage."""
  import numpy as np
  from soda_tpu import api
  from soda_tpu.backend import reference
  from soda_tpu.backend.xla import XlaExecutor
  from checks import xla_coarse

  src = """
kernel: t
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 half: x(128, *)
local half: a(0, 0) = x(0, 0) * 0.5 + x(0, 1) * 0.25
output dram 1 half: y(0, 0) = a(0, 0) + a(1, 0)
"""
  st = api.build_stencil(src)
  shape = (32, 128)
  ins = reference.make_test_inputs(st, shape)
  want = reference.run(st, ins)
  region = reference.output_valid_slices(st, shape, 'y')
  w = np.asarray(want['y'])[region]
  assert w.dtype == np.float16
  for cls in (xla_coarse, XlaExecutor):
    got = np.asarray(cls(st, shape)(ins)['y'])[region]
    np.testing.assert_array_equal(w.view(np.uint16), got.view(np.uint16))


def test_double_raises_clearly_without_x64():
  """With jax_enable_x64 off JAX silently truncates f64 arrays; the JAX
  executors refuse double stencils with guidance while the NumPy
  oracle handles them at full precision."""
  import numpy as np
  import pytest as _pytest
  from soda_tpu import api, utils
  from soda_tpu.backend import reference
  from soda_tpu.backend.xla import XlaExecutor
  from soda_tpu.parallel.spmd import ShardedExecutor

  src = """
kernel: t
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 double: x(128, *)
output dram 1 double: y(0, 0) = x(0, 0) + x(0, 1)
"""
  st = api.build_stencil(src)
  shape = (16, 128)
  want = reference.run(st, reference.make_test_inputs(st, shape))
  assert np.asarray(want['y']).dtype == np.float64
  for cls in (ShardedExecutor, XlaExecutor):
    with _pytest.raises(utils.InputError, match='jax_enable_x64'):
      cls(st, shape)


def test_wide_int_types_raise_without_x64():
  import pytest as _pytest
  from soda_tpu import api, utils
  from soda_tpu.backend.xla import XlaExecutor
  src = """
kernel: t
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 uint64: x(128, *)
output dram 1 uint64: y(0, 0) = x(0, 0) + x(0, 1)
"""
  st = api.build_stencil(src)
  with _pytest.raises(utils.InputError):
    XlaExecutor(st, (16, 128))


def test_cast_to_double_in_expr_is_guarded():
  import pytest as _pytest
  from soda_tpu import api, utils
  from soda_tpu.backend.xla import XlaExecutor
  src = """
kernel: t
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 float: x(128, *)
output dram 1 float: y(0, 0) = float(double(x(0, 0)) * 0.5)
"""
  st = api.build_stencil(src)
  with _pytest.raises(utils.InputError):
    XlaExecutor(st, (16, 128))


def test_unary_not_chain_applies_int_semantics():
  """C: !x yields int 0/1, then ~/- apply integer ops: ~!0 == -2."""
  import numpy as np
  from soda_tpu import api
  from soda_tpu.backend import reference
  src = """
kernel: t
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 int32: x(128, *)
output dram 1 int32: y(0, 0) = ~!x(0, 0)
"""
  st = api.build_stencil(src)
  shape = (8, 128)
  ins = {'x': np.zeros(shape, np.int32)}
  out = reference.run(st, ins)
  assert int(np.asarray(out['y'])[0, 0]) == ~1  # !0 == 1, ~1 == -2


def test_abs_promotes_before_applying():
  """C's abs promotes to int first: abs(int8 -128) is +128."""
  import numpy as np
  from soda_tpu import api
  from soda_tpu.backend import reference
  from soda_tpu.backend.xla import XlaExecutor
  src = """
kernel: t
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 int8: x(128, *)
output dram 1 int32: y(0, 0) = abs(x(0, 0))
"""
  st = api.build_stencil(src)
  shape = (8, 128)
  ins = {'x': np.full(shape, -128, np.int8)}
  want = reference.run(st, ins)
  assert int(np.asarray(want['y'])[0, 0]) == 128
  got = XlaExecutor(st, shape)(ins)
  np.testing.assert_array_equal(np.asarray(got['y']), np.asarray(want['y']))
