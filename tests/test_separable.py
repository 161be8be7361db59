"""Rank-1 separable factorization (soda_tpu.optimization.separable)."""

import numpy as np

from soda_tpu import api, corpus
from soda_tpu.backend import reference
from soda_tpu.backend.xla import XlaExecutor
from soda_tpu.backend.reference import output_valid_slices
from soda_tpu.optimization.separable import _linear_coeffs, _rank1

_HEADER = """
kernel: t
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
"""


def test_rank1_exact_integer_factorization():
  w = {}
  u = {-1: -1, 0: 0, 1: 1}
  v = {-1: 1, 0: 3, 1: 1}
  for i, ui in u.items():
    for j, vj in v.items():
      if ui * vj:
        w[(i, j)] = ui * vj
  fu, fv = _rank1(w)
  # factorization is unique up to sign/scale; check the product
  for (i, j), c in w.items():
    assert fu[i] * fv[j] == c


def test_rank1_rejects_rank2():
  # the jacobi cross [[0,1,0],[1,1,1],[0,1,0]] has rank 2
  w = {(0, -1): 1, (-1, 0): 1, (0, 0): 1, (1, 0): 1, (0, 1): 1}
  assert _rank1(w) is None


def test_linear_coeffs_handles_nesting():
  st = api.build_stencil(_HEADER + """
input dram 0 int16: x(128, *)
output dram 1 int16: y(0, 0) = (x(1, 0) - x(-1, 0)) * 3 - -x(0, 1)
""")
  from fractions import Fraction
  out = {}
  assert _linear_coeffs(st.output_stmts[0].expr, Fraction(1), out, [False])
  assert out == {('x', (1, 0)): 3, ('x', (-1, 0)): -3, ('x', (0, 1)): 1}


def test_sobel_factored_and_bit_exact():
  st = corpus.build('sobel2d', tile_size=(128, 0))
  names = [s.name for s in st.local_stmts]
  assert any(n.startswith('cr_var') for n in names), names
  st_plain = corpus.build('sobel2d', tile_size=(128, 0),
                          optimizations={'separable': 'no'})
  assert not any(n.startswith('cr_var')
                 for n in (s.name for s in st_plain.local_stmts))
  shape = (64, 128)
  ins = reference.make_test_inputs(st, shape)
  want = reference.run(st_plain, ins)
  region = output_valid_slices(st_plain, shape, 'mag')
  got_oracle = reference.run(st, ins)
  got_xla = XlaExecutor(st, shape)(ins)
  np.testing.assert_array_equal(np.asarray(want['mag'])[region],
                                np.asarray(got_oracle['mag'])[region])
  np.testing.assert_array_equal(np.asarray(want['mag'])[region],
                                np.asarray(got_xla['mag'])[region])


def test_float_and_small_stages_untouched():
  # float stages are out of scope; tiny / rank-2 integer stages must
  # not grow extra stages
  for name in ('jacobi2d', 'blur', 'denoise2d'):
    with_pass = corpus.build(name, tile_size=(128, 0))
    without = corpus.build(name, tile_size=(128, 0),
                           optimizations={'separable': 'no'})
    assert len(with_pass.local_stmts) == len(without.local_stmts), name


def test_rank1_with_offset_store_is_exact():
  # non-centered offsets + a store index away from the origin
  src = _HEADER + """
input dram 0 int16: x(128, *)
output dram 1 int16: y(1, 2) = x(0, 0) * 2 + x(0, 1) * 4 + x(0, 3) * 10 +
  x(2, 0) * 3 + x(2, 1) * 6 + x(2, 3) * 15 +
  x(4, 0) * 5 + x(4, 1) * 10 + x(4, 3) * 25
"""
  st = api.build_stencil(src)
  st_plain = api.build_stencil(src, optimizations={'separable': 'no'})
  assert len(st.local_stmts) == 1  # [2,3] x [1,2] factored
  shape = (32, 128)
  ins = reference.make_test_inputs(st, shape)
  want = reference.run(st_plain, ins)
  got = reference.run(st, ins)
  region = output_valid_slices(st_plain, shape, 'y')
  np.testing.assert_array_equal(np.asarray(want['y'])[region],
                                np.asarray(got['y'])[region])


def test_seidel_float_rank1_factored_within_tolerance():
  """The 3x3 uniform float window factors as [1,1,1] x [1,1,1] with
  the original literal reconstructed exactly as ONE scalar multiply;
  results differ from the unfactored program only by reassociation
  rounding (the same license rebalance and CR take on floats)."""
  st = corpus.build('seidel2d', tile_size=(128, 0))
  assert any(s.name.startswith('cr_var') for s in st.local_stmts)
  assert '.1111111f' in str(st) or '0.1111111' in str(st)
  st_plain = corpus.build('seidel2d', tile_size=(128, 0),
                          optimizations={'separable': 'no'})
  shape = (64, 128)
  ins = reference.make_test_inputs(st, shape)
  want = reference.run(st_plain, ins)
  got = reference.run(st, ins)
  region = output_valid_slices(st_plain, shape, 'output')
  w = np.asarray(want['output'])[region]
  g = np.asarray(got['output'])[region]
  rel = np.abs(w - g) / (np.abs(w) + 1e-9)
  assert rel.max() < 1e-5


def test_int_parent_with_fractional_coeffs_untouched():
  # mixed int-parent / float-coefficient stages are skipped (their
  # rounding order is not ours to re-associate)
  st = api.build_stencil(_HEADER + """
input dram 0 int16: x(128, *)
output dram 1 float: y(0, 0) = (x(0, 0) + x(0, 1) + x(0, 3) +
  x(2, 0) + x(2, 1) + x(2, 3) +
  x(4, 0) + x(4, 1) + x(4, 3)) * 0.25f
""")
  assert not st.local_stmts


def test_mixed_parent_fractional_int_coeff_bails_whole_stmt():
  """A fractional coefficient on an INT parent must bail the ENTIRE
  statement: factoring any other parent would rebuild the int taps
  from collapsed float coefficients, re-associating arithmetic the
  pass promises not to touch (code-review regression)."""
  src = _HEADER + """
input dram 0 int16: a(128, *)
input dram 0 int16: b(128, *)
output dram 1 float: y(0, 0) = a(0, 0) * 2 + a(0, 1) * 4 + a(0, 3) * 10 +
  a(2, 0) * 3 + a(2, 1) * 6 + a(2, 3) * 15 +
  a(4, 0) * 5 + a(4, 1) * 10 + a(4, 3) * 25 +
  (b(0, 0) + b(0, 1)) * 0.2f
"""
  st = api.build_stencil(src)
  assert not st.local_stmts  # nothing factored; statement untouched
  st_plain = api.build_stencil(src, optimizations={'separable': 'no'})
  assert str(st.output_stmts[0].expr) == str(st_plain.output_stmts[0].expr)


def test_preserve_border_with_factored_stages():
  """border: preserve must stay bit-exact when stages are factored
  (the factorization preserves the overall stencil window, so the
  preserved boundary region is identical)."""
  st = corpus.build('sobel2d', tile_size=(128, 0), border='preserve')
  st_plain = corpus.build('sobel2d', tile_size=(128, 0),
                          border='preserve',
                          optimizations={'separable': 'no'})
  shape = (48, 128)
  ins = reference.make_test_inputs(st, shape)
  want = reference.run(st_plain, ins)
  got = XlaExecutor(st, shape, cluster='coarse')(ins)
  np.testing.assert_array_equal(np.asarray(want['mag']),
                                np.asarray(got['mag']))


def test_integral_float_literal_coeff_on_int_parent_bails():
  """3. * x computes in f32 even though the value is integral; the
  exact-integer rewrite path must not claim it (code-review)."""
  src = _HEADER + """
input dram 0 int32: x(128, *)
output dram 1 int32: y(0, 0) = x(0, 0) * 2. + x(0, 1) * 4. + x(0, 3) * 10. +
  x(2, 0) * 3. + x(2, 1) * 6. + x(2, 3) * 15. +
  x(4, 0) * 5. + x(4, 1) * 10. + x(4, 3) * 25.
"""
  st = api.build_stencil(src)
  assert not st.local_stmts  # nothing factored
