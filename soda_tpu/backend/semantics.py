"""Shared evaluation semantics for stencil expressions.

The reference's correctness contract is "bit-exact vs the generated C++
scalar host" (/root/reference/src/soda/codegen/frt/host.py:558-660): the
host evaluates each statement expression with C arithmetic — integer
operands promoted to (u)int32 before arithmetic, truncating division,
wrap-around only at statement stores and explicit casts — while float
arithmetic runs at the operands' native precision.

This module implements exactly those semantics once, parameterized over
the array namespace (``numpy`` for the oracle, ``jax.numpy`` for the
JAX executors), so every executor in the framework shares one
definition of "what a statement means".
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from soda_tpu import utils
from soda_tpu.ir import nodes as ir
from soda_tpu.ir.types import Type

# C "usual arithmetic conversions": integer types narrower than int are
# promoted to int before any arithmetic. (C11 §6.3.1.1; the generated
# host code at reference frt/host.py:558-624 relies on this.)
_INT = Type('int32')


def promote(t: Type) -> Type:
  """C integer promotion: sub-int widths widen to int32."""
  if t.is_float:
    return t
  if t.width_in_bits < 32:
    return _INT
  # 33..64-bit widths compute in 64-bit storage
  if t.width_in_bits > 32:
    return Type('int64' if t.is_signed else 'uint64')
  return Type('int32' if t.is_signed else 'uint32')


def binary_type(a: Optional[Type], b: Optional[Type]) -> Type:
  """Result type of a C binary arithmetic op after promotion."""
  if a is None and b is None:
    return _INT
  if a is None:
    return promote(b)
  if b is None:
    return promote(a)
  a, b = promote(a), promote(b)
  if a.is_float or b.is_float:
    if not a.is_float:
      return b
    if not b.is_float:
      return a
    return a if a.width_in_bits >= b.width_in_bits else b
  if a.width_in_bits == b.width_in_bits:
    if a.is_signed == b.is_signed:
      return a
    return a if not a.is_signed else b  # unsigned wins at equal rank
  return a if a.width_in_bits > b.width_in_bits else b


def wrap(xp, value, dtype: Type):
  """Convert ``value`` to ``dtype`` with C wrap-around semantics.

  Equivalent to the implicit conversion at a C assignment / ap_int
  truncation at a store: modular wrap for integers (including
  non-power-of-two widths), ordinary conversion for floats.
  """
  if dtype.is_float:
    return xp.asarray(value).astype(dtype.np_dtype)
  value = xp.asarray(value)
  if value.dtype.kind == 'f':
    # C float->int conversion truncates toward zero
    value = xp.trunc(value)
  if dtype.needs_mask:
    n = dtype.width_in_bits
    mask = (1 << n) - 1
    wide = value.astype('int64' if n < 64 else dtype.np_dtype)
    wide = wide & mask
    if dtype.is_signed:
      sign = 1 << (n - 1)
      wide = (wide ^ sign) - sign
    return wide.astype(dtype.np_dtype)
  return value.astype(dtype.np_dtype)


def _as(xp, value, dtype: Type):
  return xp.asarray(value).astype(dtype.np_dtype)


def _all_types(stencil):
  """Every type the program touches: declared tensors/params, in-expr
  casts, and typed lets (casts to half/double are invisible in the
  symbol table but hit the same backend limits)."""
  for t in stencil.symbol_table.values():
    yield t
  found = []

  def collect(node, _):
    if isinstance(node, ir.Cast) and node.dtype is not None:
      found.append(node.dtype)
    return node

  for stmt in stencil.local_stmts + stencil.output_stmts:
    stmt.expr.visit(collect)
    for let in stmt.let:
      if let.dtype is not None:
        found.append(let.dtype)
      let.visit(collect)
  yield from found


def require_f64_support(stencil) -> None:
  """Raise a clear error when a 64-bit-typed stencil meets JAX with
  ``jax_enable_x64`` off: JAX then silently truncates float64/int64
  astype, so double would crash on dtype mismatches mid-kernel and
  wide ints would silently wrap at 32 bits against the oracle. The
  NumPy oracle supports all widths."""
  import jax
  if jax.config.jax_enable_x64:
    return
  for t in _all_types(stencil):
    if t is None:
      continue
    wide_float = t.is_float and t.width_in_bits == 64
    wide_int = not t.is_float and t.width_in_bits > 32
    if wide_float or wide_int:
      raise utils.InputError(
          'type %s needs 64-bit types, but jax_enable_x64 is off '
          '(JAX would silently truncate to 32 bits). Use <=32-bit '
          'types or enable jax_enable_x64; the NumPy oracle '
          '(backend.reference) supports every width.' % t)


def _pow2_exponent(node) -> 'Optional[int]':
  """k if ``node`` is the positive integer literal 2^k (k >= 1)."""
  while isinstance(node, ir.CHAIN_CLASSES) and len(node.operand) == 1:
    node = node.operand[0]
  if isinstance(node, ir.Num) and isinstance(node.value, int):
    v = node.value
    if v >= 2 and (v & (v - 1)) == 0:
      return v.bit_length() - 1
  return None


def c_int_div(xp, a, b):
  """C integer division: truncation toward zero (ISO C99 §6.5.5)."""
  q = a // b
  r = a - q * b
  # floor and trunc differ iff remainder != 0 and signs differ
  fix = (r != 0) & ((a < 0) != (b < 0))
  return q + fix.astype(q.dtype)


def c_int_mod(xp, a, b):
  """C % : remainder with the sign of the dividend."""
  return a - c_int_div(xp, a, b) * b


class Evaluator:
  """Evaluate one statement expression under C semantics.

  Args:
    xp: array namespace (numpy or jax.numpy).
    load: callback ``load(ref: ir.Ref) -> array`` producing the (already
      shifted/sliced) value of a tensor access. All arrays a single
      statement loads must be shape-broadcastable against each other.
    env: name -> value for ``let`` bindings and scalar vars.
    param: optional callback ``param(name, idx) -> array`` for kernel
      parameter element access.
    intrinsics: optional overrides for intrinsic call implementations.
  """

  def __init__(self, xp, load: Callable[[ir.Ref], Any],
               env: Optional[Dict[str, Tuple[Any, Optional[Type]]]] = None,
               param: Optional[Callable[[str, Tuple[int, ...]], Any]] = None,
               fast_int_div: bool = False,
               fast_rsqrt: bool = False):
    self.xp = xp
    self.load = load
    self.env = dict(env or {})
    self.param = param
    # strength-reduce integer division to a float32 divide where the
    # range analysis proved it bit-exact (soda_tpu.optimization.ranges);
    # the oracle keeps pure C division so tests differentially verify
    # the proof
    self.fast_int_div = fast_int_div
    # x / sqrt(y) -> x * rsqrt(y): one hardware reciprocal square root
    # instead of a square root and a divide, within a couple of ulps of
    # the divide (well inside the reference THRESHOLD). Only the
    # jax-backed executors set this; the oracle keeps sqrt + divide so
    # tests differentially bound the substitution's error.
    self.fast_rsqrt = fast_rsqrt

  def bind(self, name: str, value, dtype: Optional[Type]) -> None:
    self.env[name] = (value, dtype)

  def eval_stmt(self, tensor_or_stmt):
    """Evaluate lets then the expression; returns (value, dtype)."""
    lets = getattr(tensor_or_stmt, 'lets', None)
    if lets is None:
      lets = getattr(tensor_or_stmt, 'let', ())
    for let in lets:
      value, dtype = self.eval(let.expr)
      if let.dtype is not None:
        value = wrap(self.xp, value, let.dtype)
        dtype = let.dtype
      self.bind(let.name, value, dtype)
    return self.eval(tensor_or_stmt.expr)

  # -- expression dispatch ----------------------------------------------------
  def eval(self, node: ir.Node) -> Tuple[Any, Optional[Type]]:
    xp = self.xp
    if isinstance(node, ir.Num):
      # untyped int literals participate in promotion lazily (dtype None)
      return node.value, node.dtype
    if isinstance(node, ir.Ref):
      value = self.load(node)
      dtype = node.dtype
      if (dtype is not None and dtype.is_float and
          dtype.width_in_bits == 16):
        # half is a STORAGE format: arithmetic runs at float32 and
        # rounds to f16 at stage stores (the same shape as the
        # sub-32-bit int promotion). The oracle applies the identical
        # rule, so all executors share one half-precision semantic.
        value = _as(xp, value, Type('float'))
        dtype = Type('float')
      return value, dtype
    if isinstance(node, ir.Var):
      if node.idx:
        if self.param is None:
          raise utils.InternalError('no param accessor for %s' % node)
        return self.param(node.name, tuple(node.idx)), node.dtype
      if node.name not in self.env:
        raise utils.InternalError('unbound variable: %s' % node.name)
      return self.env[node.name]
    if isinstance(node, ir.Cast):
      value, _ = self.eval(node.expr)
      return wrap(xp, value, node.dtype), node.dtype
    if isinstance(node, ir.Unary):
      value, dtype = self.eval(node.operand)
      if (dtype is not None and not dtype.is_float and
          any(op in '-~' for op in node.operator)):
        # C integer promotion applies to unary operands too
        # (C11 §6.5.3.3): -uint16(1) is -(int)1 == -1, not 65535
        ptype = promote(dtype)
        if ptype.width_in_bits != dtype.width_in_bits or \
            ptype.is_signed != dtype.is_signed:
          value = _as(xp, value, ptype)
          dtype = ptype
      for op in reversed(node.operator):
        if op == '-':
          value = -value
        elif op == '~':
          value = ~value
        elif op == '!':
          # C's ! yields int 0/1 (C11 §6.5.3.3); materialize it so a
          # following -/~ applies integer semantics, not bool ops
          value = _as(xp, xp.logical_not(value), _INT)
          dtype = _INT
        elif op == '+':
          pass
        else:
          raise utils.InternalError('unknown unary operator: %s' % op)
      return value, dtype
    if isinstance(node, ir.Call):
      return self._eval_call(node)
    if isinstance(node, ir.CHAIN_CLASSES):
      return self._eval_chain(node)
    raise utils.InternalError('cannot evaluate %r' % node)

  def _coerce_pair(self, av, at, bv, bt):
    """Bring two operands to their common C arithmetic type."""
    xp = self.xp
    out = binary_type(at, bt)
    return _as(xp, av, out), _as(xp, bv, out), out

  def _eval_chain(self, node) -> Tuple[Any, Optional[Type]]:
    xp = self.xp
    # operands are evaluated LAZILY, one per fold step: long reduction
    # chains (e.g. a 19-tap sum) then keep at most two grid-sized
    # temporaries live in the eager NumPy oracle
    div_ok = getattr(node, 'div_f32_ok', None) if self.fast_int_div \
        else None
    acc, acc_t = self.eval(node.operand[0])
    for pos, (opd, op) in enumerate(zip(node.operand[1:], node.operator)):
      if (op == '/' and self.fast_rsqrt and isinstance(opd, ir.Call) and
          opd.name == 'sqrt' and (acc_t is None or acc_t.is_float)):
        from jax import lax  # fast_rsqrt implies xp is jax.numpy
        inner_v, inner_t = self.eval(opd.operand[0])
        ftype = inner_t if inner_t is not None and inner_t.is_float \
            else Type('float')
        rs = lax.rsqrt(_as(xp, inner_v, ftype))
        acc, rs, out = self._coerce_pair(acc, acc_t, rs, ftype)
        acc = acc * rs
        acc_t = out
        continue
      val, val_t = self.eval(opd)
      acc, val, out = self._coerce_pair(acc, acc_t, val, val_t)
      if op == '+':
        acc = acc + val
      elif op == '-':
        acc = acc - val
      elif op == '*':
        acc = acc * val
      elif op == '/':
        k = _pow2_exponent(opd) if self.fast_int_div else None
        if out.is_float:
          acc = acc / val
        elif k is not None:
          # division by a constant 2^k: exact truncating shift (the
          # bias rounds negatives toward zero, ISO C99 §6.5.5) — 1-3
          # integer ops instead of the general C division sequence
          if out.is_signed:
            bias = xp.right_shift(acc, out.width_in_bits - 1) & \
                ((1 << k) - 1)
            acc = xp.right_shift(acc + bias, k)
          else:
            acc = xp.right_shift(acc, k)
        elif div_ok is not None and pos < len(div_ok) and div_ok[pos]:
          # provably exact in float32 (see optimization/ranges.py)
          f32 = Type('float').np_dtype
          acc = (acc.astype(f32) / val.astype(f32)).astype(out.np_dtype)
        else:
          acc = c_int_div(xp, acc, val)
      elif op == '%':
        acc = c_int_mod(xp, acc, val)
      elif op == '&':
        acc = acc & val
      elif op == '|':
        acc = acc | val
      elif op == '^':
        acc = acc ^ val
      elif op == '==':
        acc, out = acc == val, Type('uint1')
      elif op == '!=':
        acc, out = acc != val, Type('uint1')
      elif op == '<':
        acc, out = acc < val, Type('uint1')
      elif op == '<=':
        acc, out = acc <= val, Type('uint1')
      elif op == '>':
        acc, out = acc > val, Type('uint1')
      elif op == '>=':
        acc, out = acc >= val, Type('uint1')
      elif op == '&&':
        acc, out = xp.logical_and(acc, val), Type('uint1')
      elif op == '||':
        acc, out = xp.logical_or(acc, val), Type('uint1')
      else:
        raise utils.InternalError('unknown operator: %s' % op)
      acc_t = out
    return acc, acc_t

  def _eval_call(self, node: ir.Call) -> Tuple[Any, Optional[Type]]:
    xp = self.xp
    name = node.name
    if name in ('min', 'max'):
      # lazy fold (see _eval_chain): bounds live temporaries. Ints
      # keep the C promotion (min/max are bit-identical either way)
      fn = xp.minimum if name == 'min' else xp.maximum
      acc, acc_t = self.eval(node.operand[0])
      for opd in node.operand[1:]:
        val, val_t = self.eval(opd)
        acc, val, acc_t = self._coerce_pair(acc, acc_t, val, val_t)
        acc = fn(acc, val)
      return acc, acc_t
    args = [self.eval(o) for o in node.operand]
    if name == 'select':
      cond = args[0][0]
      av, at = args[1]
      bv, bt = args[2]
      av, bv, out = self._coerce_pair(av, at, bv, bt)
      return xp.where(cond, av, bv), out
    if name == 'abs':
      val, t = args[0]
      if t is not None and not t.is_float:
        # C's abs promotes to int first: abs(int8 -128) is +128
        pt = promote(t)
        if pt.width_in_bits != t.width_in_bits:
          val, t = _as(xp, val, pt), pt
      return xp.abs(val), t
    if name == 'pow':
      (av, at), (bv, bt) = args
      out = binary_type(at, bt)
      if not out.is_float:
        out = Type('float')
      return xp.power(_as(xp, av, out), _as(xp, bv, out)), out
    # unary float intrinsics: ints promote to float32 (C float overload)
    val, t = args[0]
    out = t if (t is not None and t.is_float) else Type('float')
    val = _as(xp, val, out)
    table = {
        'sqrt': xp.sqrt, 'rsqrt': lambda x: 1 / xp.sqrt(x), 'exp': xp.exp,
        'log': xp.log, 'sin': xp.sin, 'cos': xp.cos, 'tan': xp.tan,
        'tanh': xp.tanh, 'floor': xp.floor, 'ceil': xp.ceil,
        'round': xp.round,
    }
    if name not in table:
      raise utils.InternalError('unknown intrinsic: %s' % name)
    return table[name](val), out


