"""Value-range analysis over the tensor DAG.

Interval arithmetic from the inputs' declared integer widths through
every stage expression. Its product is the ``div_f32_ok`` annotation on
MulDiv nodes: an integer division whose dividend and divisor provably
fit in float32's 24-bit mantissa can be computed as a float32 divide +
truncate with bit-exact C semantics, in place of the multi-instruction
sequence a general integer division compiles to (the blur kernel's
``/ 3``).

Exactness argument: for |n|, |d| < 2^23, the correctly-rounded float32
quotient fl(n/d) never crosses an integer boundary away from n/d —
if d | n the quotient is an exactly-representable integer, otherwise
its distance to the nearest integer is >= 1/|d| > ulp(n/d)/2 — so
trunc(fl(n/d)) == C's truncating division, negatives included.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from soda_tpu.ir import nodes as ir
from soda_tpu.ir.types import Type

_LIMIT = 1 << 23  # float32 mantissa bound
_UNBOUNDED = (float('-inf'), float('inf'))

Range = Tuple[float, float]


def _type_range(dtype: Optional[Type]) -> Range:
  if dtype is None or dtype.is_float:
    return _UNBOUNDED
  n = dtype.width_in_bits
  if dtype.is_signed:
    return (-(1 << (n - 1)), (1 << (n - 1)) - 1)
  return (0, (1 << n) - 1)


def _clip_to_type(r: Range, dtype: Optional[Type]) -> Range:
  """Range after a wrap to ``dtype``: unchanged if it already fits,
  else the full type range (wrap-around loses all information)."""
  tr = _type_range(dtype)
  if tr[0] <= r[0] and r[1] <= tr[1]:
    return r
  return tr


def _add(a: Range, b: Range) -> Range:
  return (a[0] + b[0], a[1] + b[1])


def _sub(a: Range, b: Range) -> Range:
  return (a[0] - b[1], a[1] - b[0])


def _mul(a: Range, b: Range) -> Range:
  products = [x * y for x in a for y in b]
  return (min(products), max(products))


def _div(a: Range, b: Range) -> Range:
  if b[0] <= 0 <= b[1]:
    return _UNBOUNDED
  quotients = [x / y for x in a for y in b]
  return (min(quotients), max(quotients))


class _Analyzer:

  def __init__(self, stencil, tensor_ranges: Dict[str, Range]):
    self.stencil = stencil
    self.tensor_ranges = tensor_ranges
    self.env: Dict[str, Range] = {}

  def range_of(self, node: ir.Node) -> Range:
    if isinstance(node, ir.Num):
      return (node.value, node.value)
    if isinstance(node, ir.Ref):
      if node.name in self.stencil.param_names:
        return _type_range(self.stencil.symbol_table.get(node.name))
      return self.tensor_ranges.get(node.name, _UNBOUNDED)
    if isinstance(node, ir.Var):
      return self.env.get(node.name, _UNBOUNDED)
    if isinstance(node, ir.Cast):
      return _clip_to_type(self.range_of(node.expr), node.dtype)
    if isinstance(node, ir.Unary):
      r = self.range_of(node.operand)
      for op in node.operator:
        if op == '-':
          r = (-r[1], -r[0])
        elif op in ('~', '!'):
          r = _UNBOUNDED
      return r
    if isinstance(node, ir.Call):
      rs = [self.range_of(o) for o in node.operand]
      if node.name == 'min':
        return (min(r[0] for r in rs), min(r[1] for r in rs))
      if node.name == 'max':
        return (max(r[0] for r in rs), max(r[1] for r in rs))
      if node.name == 'abs':
        lo, hi = rs[0]
        m = max(abs(lo), abs(hi))
        return (0 if lo <= 0 <= hi else min(abs(lo), abs(hi)), m)
      return _UNBOUNDED
    if isinstance(node, (ir.EqCmp, ir.LtCmp, ir.Expr, ir.LogicAnd)):
      if len(node.operand) == 1:
        # bare chain wrapper (parenthesized subexpression), not a
        # comparison: the range passes through
        return self.range_of(node.operand[0])
      self._descend(node)
      return (0, 1)
    if isinstance(node, ir.AddSub):
      acc = self.range_of(node.operand[0])
      for op, opd in zip(node.operator, node.operand[1:]):
        r = self.range_of(opd)
        acc = _add(acc, r) if op == '+' else _sub(acc, r)
      return acc
    if isinstance(node, ir.MulDiv):
      acc = self.range_of(node.operand[0])
      any_float = _is_float_node(node.operand[0])
      flags = []
      for op, opd in zip(node.operator, node.operand[1:]):
        r = self.range_of(opd)
        any_float = any_float or _is_float_node(opd)
        if op == '*':
          acc = _mul(acc, r)
          flags.append(False)
        elif op == '/':
          ok = (not any_float and
                -_LIMIT < acc[0] and acc[1] < _LIMIT and
                -_LIMIT < r[0] and r[1] < _LIMIT and
                not (r[0] <= 0 <= r[1]))
          flags.append(bool(ok))
          acc = _div(acc, r)
        else:  # '%'
          flags.append(False)
          acc = _UNBOUNDED if r[0] <= 0 <= r[1] else \
              (-max(abs(r[0]), abs(r[1])), max(abs(r[0]), abs(r[1])))
      node.div_f32_ok = tuple(flags)
      return acc
    if isinstance(node, ir.CHAIN_CLASSES):
      self._descend(node)
      return _UNBOUNDED
    return _UNBOUNDED

  def _descend(self, node) -> None:
    for opd in getattr(node, 'operand', ()):
      self.range_of(opd)


def _is_float_node(node: ir.Node) -> bool:
  return node.dtype is not None and node.dtype.is_float


def annotate(stencil) -> Dict[str, Range]:
  """Annotate every tensor's expression tree; returns tensor ranges.

  Idempotent (cached on the stencil). Must run after all IR passes:
  the annotations live on the final tensor expression nodes.
  """
  cached = getattr(stencil, '_tensor_ranges', None)
  if cached is not None:
    return cached
  ranges: Dict[str, Range] = {}
  for name in stencil.input_names:
    ranges[name] = _type_range(stencil.symbol_table[name])
  for tensor in stencil.chronological_tensors:
    if tensor.is_input():
      continue
    analyzer = _Analyzer(stencil, ranges)
    for let in tensor.lets:
      r = analyzer.range_of(let.expr)
      if let.dtype is not None:
        r = _clip_to_type(r, let.dtype)
      analyzer.env[let.name] = r
    r = analyzer.range_of(tensor.expr)
    ranges[tensor.name] = _clip_to_type(r, tensor.dtype)
  stencil._tensor_ranges = ranges
  return ranges
