"""Rank-1 separable factorization of linear stencil stages.

A 2-D linear stage whose per-parent coefficient matrix W (indexed by
the two DSL-dim offsets) has rank 1 factors exactly as W = u (outer) v
with integer u, v: the stage then computes as a 1-D pass along dim 1
followed by a 1-D combine along dim 0 — |D0| + |D1| shifted reads
instead of |D0| x |D1|. The classic instance is Sobel: the 3x3
gradient [[-1,-3,-1],[0,0,0],[1,3,1]] is [-1,0,1] (outer) [1,3,1], and
factoring both gradients cuts the kernel's shifted-load count from 12
(8 of them diagonal, costing a shift on each axis) to 8 single-axis
shifts.

Exactness: intermediates are stored at the C-promoted width, so the
rewritten sums are plain reassociations of the original promoted-width
arithmetic — congruent mod 2^32 by ring identities, hence bit-exact
through the final store wrap (restricted to integer stages). No
reference counterpart (the
reference's FPGA line buffers make diagonal taps free, so it never
needs this); closest relative is its GLORE scheduler's axis grouping
(computation_reuse.py:1523-1689).
"""

from __future__ import annotations

import itertools
import logging
from fractions import Fraction
from math import gcd
from typing import Dict, List, Optional, Tuple

from soda_tpu.ir import nodes as ir

_logger = logging.getLogger().getChild(__name__)

Coeffs = Dict[Tuple[str, Tuple[int, ...]], Fraction]


def _linear_coeffs(node: ir.Node, scale: Fraction, out: Coeffs,
                   saw_float: List[bool]) -> bool:
  """Accumulate coefficients per (parent, idx) as exact Fractions
  (float literals convert exactly — binary floats are rationals);
  False = the expression is not a linear combination of refs.
  ``saw_float[0]`` records whether any coefficient came from a FLOAT
  literal: that makes the original arithmetic float even when the
  value is integral (3. * x computes in f32), so the exact-integer
  rewrite path must not claim it."""
  if isinstance(node, ir.Ref):
    if node.lat is not None:
      return False
    key = (node.name, tuple(node.idx))
    out[key] = out.get(key, 0) + scale
    return True
  if isinstance(node, ir.Unary):
    for op in node.operator:
      if op == '-':
        scale = -scale
      else:
        return False
    return _linear_coeffs(node.operand, scale, out, saw_float)
  if isinstance(node, ir.AddSub):
    if not _linear_coeffs(node.operand[0], scale, out, saw_float):
      return False
    for op, opd in zip(node.operator, node.operand[1:]):
      if not _linear_coeffs(opd, scale if op == '+' else -scale, out,
                            saw_float):
        return False
    return True
  if isinstance(node, ir.MulDiv):
    if set(node.operator) != {'*'}:
      return False
    body = None
    for opd in node.operand:
      if isinstance(opd, ir.Num):
        if isinstance(opd.value, float):
          saw_float[0] = True
        scale *= Fraction(opd.value)
      elif body is None:
        body = opd
      else:
        return False  # product of two non-constants: nonlinear
    if body is None:
      return False  # pure constant term
    return _linear_coeffs(body, scale, out, saw_float)
  if isinstance(node, ir.CHAIN_CLASSES) and len(node.operand) == 1:
    return _linear_coeffs(node.operand[0], scale, out, saw_float)
  return False


def _rank1(matrix: Dict[Tuple[int, int], int]
           ) -> Optional[Tuple[Dict[int, int], Dict[int, int]]]:
  """Exact integer rank-1 factorization W[i][j] = u[i] * v[j], or None.

  Offsets (i, j) absent from ``matrix`` are zero entries; the returned
  u, v omit zero components.
  """
  rows: Dict[int, Dict[int, int]] = {}
  for (i, j), c in matrix.items():
    if c:
      rows.setdefault(i, {})[j] = c
  if not rows:
    return None
  # primitive basis = first nonzero row / its gcd
  base_i = min(rows)
  base = rows[base_i]
  g = 0
  for c in base.values():
    g = gcd(g, abs(c))
  v = {j: c // g for j, c in base.items()}
  u: Dict[int, int] = {}
  j0 = min(v)
  for i, row in rows.items():
    if set(row) != set(v):
      return None
    ratio = Fraction(row[j0], v[j0])
    if ratio.denominator != 1:
      return None
    for j, c in row.items():
      if c != ratio * v[j]:
        return None
    u[i] = int(ratio)
  return u, v


def _term(coeff, ref: ir.Node) -> ir.Node:
  if coeff == 1:
    return ref
  if coeff == -1:
    return ir.Unary(operator=('-',), operand=ref)
  if isinstance(coeff, Fraction) and coeff.denominator != 1:
    # non-integer coefficient: emit the (float32) literal; the rewrite
    # is float reassociation, tolerated like rebalance/CR on floats
    from soda_tpu.ir.types import Type
    num = ir.make_num(float(coeff), Type('float'))
  else:
    num = ir.make_num(int(coeff))
  return ir.MulDiv(operator=('*',), operand=(num, ref))


def _sum_terms(terms) -> ir.Node:
  return ir.make_chain('+', tuple(terms))


def separable(stencil) -> None:
  """Factor rank-1 linear stages in place (2-D integer stencils)."""
  from soda_tpu.frontend import ast
  from soda_tpu.ir import arithmetic
  from soda_tpu.backend.semantics import promote

  if len(stencil.tile_size) != 2:
    return
  new_locals = []
  for stmt in itertools.chain(stencil.local_stmts, stencil.output_stmts):
    if stmt.let:
      continue
    coeffs: Coeffs = {}
    saw_float = [False]
    if not _linear_coeffs(stmt.expr, Fraction(1), coeffs, saw_float):
      continue
    by_parent: Dict[str, Dict[Tuple[int, int], Fraction]] = {}
    types_ok = True
    for (name, idx), c in coeffs.items():
      dtype = stencil.symbol_table.get(name)
      if dtype is None or name in stencil.param_names:
        types_ok = False
        break
      # a factoring of ANY parent rebuilds the whole statement from
      # the collapsed coefficients; for an integer parent that is only
      # exact (mod-2^n reassociation) when its coefficients are true
      # INTEGER literals — a fractional coefficient, or a float literal
      # with an integral value (3. * x computes in f32), bails the
      # entire statement, not just that parent's factoring
      if not dtype.is_float and (c.denominator != 1 or saw_float[0]):
        types_ok = False
        break
      by_parent.setdefault(name, {})[tuple(idx)] = c
    if not types_ok:
      continue
    rebuilt = []
    changed = False
    for name, matrix in sorted(by_parent.items()):
      taps = [(ij, c) for ij, c in matrix.items() if c]
      d0 = {i for (i, _), _ in taps}
      d1 = {j for (_, j), _ in taps}
      factored = None
      if len(taps) >= 4 and len(d0) >= 2 and len(d1) >= 2:
        # scale the rational matrix to integers (exact: float literals
        # are rationals); the residue 1/L becomes one scalar multiply
        lcm = 1
        for _, c in taps:
          lcm = lcm * c.denominator // gcd(lcm, c.denominator)
        factored = _rank1({ij: int(c * lcm) for ij, c in taps})
      if factored is None:
        rebuilt.extend(
            _term(c, ir.Ref(name=name, idx=ij, lat=None))
            for ij, c in sorted(taps))
        continue
      u, v = factored
      # shifted-load economics: |D0 x D1| two-axis taps vs |D1| + |D0|
      # single-axis taps + one extra stage
      before = sum((i != 0) + (j != 0) for (i, j), _ in taps)
      after = sum(j != 0 for j in v) + sum(i != 0 for i in u) + 1
      if before - after < 2:
        rebuilt.extend(
            _term(c, ir.Ref(name=name, idx=ij, lat=None))
            for ij, c in sorted(taps))
        continue
      if lcm != 1:
        # pull the common factor out of u so the residual scalar is a
        # SINGLE multiply: u = g * u' (primitive); scalar = g / lcm
        # (for seidel-like uniform windows this reconstructs the
        # original literal exactly: sum * .1111111f)
        g_u = 0
        for c in u.values():
          g_u = gcd(g_u, abs(c))
        u = {i: c // g_u for i, c in u.items()}
        scale_frac = Fraction(g_u, lcm)
      else:
        scale_frac = Fraction(1)
      parent_dtype = stencil.symbol_table[name]
      is_int = not parent_dtype.is_float
      if is_int and lcm != 1:
        # fractional coefficients on an integer parent: mixed-type
        # arithmetic whose rounding we will not re-associate
        rebuilt.extend(
            _term(c, ir.Ref(name=name, idx=ij, lat=None))
            for ij, c in sorted(taps))
        continue
      changed = True
      sep = stencil.new_cr_var()
      sep_dtype = promote(parent_dtype) if is_int else parent_dtype
      sep_expr = arithmetic.simplify(stencil.propagate_type(_sum_terms(
          _term(c, ir.Ref(name=name, idx=(0, j), lat=None))
          for j, c in sorted(v.items()))))
      new_locals.append(
          ast.LocalStmt(ref=ir.Ref(name=sep, idx=(0, 0), lat=None),
                        dtype=sep_dtype, expr=sep_expr, let=(),
                        stencil=stencil))
      core = _sum_terms(
          _term(c, ir.Ref(name=sep, idx=(i, 0), lat=None))
          for i, c in sorted(u.items()))
      if scale_frac != 1:
        from soda_tpu.ir.types import Type
        scale = ir.make_num(float(scale_frac), Type('float'))
        core = ir.MulDiv(operator=('*',), operand=(core, scale))
      rebuilt.append(core)
      _logger.info(
          'separable: %s reads %s as a rank-1 [%s] x [%s] pair (%s)',
          stmt.name, name,
          ','.join(str(u[i]) for i in sorted(u)),
          ','.join(str(v[j]) for j in sorted(v)), sep)
    if changed:
      stmt.expr = arithmetic.simplify(
          stencil.propagate_type(_sum_terms(rebuilt)))
  if new_locals:
    stencil.local_stmts.extend(new_locals)
    stencil.__dict__.pop('symbol_table', None)
    stencil.__dict__.pop('local_names', None)
    stencil.__dict__.pop('local_types', None)
