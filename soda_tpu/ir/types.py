"""Scalar type system for the stencil IR.

Plays the role of the external ``haoda.ir.Type`` in the reference
(see /root/reference/src/soda/grammar.py:10 and SURVEY.md §2.9), redesigned
for a JAX/NumPy execution model: every type knows its NumPy/JAX storage
dtype and whether exact-width masking is required to emulate arbitrary
bit-width integer wrap-around (the reference emulates these with HLS
``ap_int``/``ap_uint``; we emulate with the next power-of-two dtype plus a
mask after every operation).

Supported type names (same surface as the reference DSL, README.md:222):
  - ``intN`` / ``uintN`` for any N >= 1 (e.g. int16, uint6, int27)
  - ``float`` (32-bit), ``double`` (64-bit), ``half`` (16-bit)
  - parametrized floats ``floatW`` / ``floatW_E`` (width W, exponent E);
    these execute as the narrowest standard float that can hold them.
"""

from __future__ import annotations

import functools
import re
from typing import Optional, Tuple

import numpy as np

_INT_RE = re.compile(r'^(u?)int([1-9][0-9]*)$')
_FLOAT_RE = re.compile(r'^float([1-9][0-9]*)(?:_([0-9]+))?$')

_STD_FLOATS = {'half': 16, 'float': 32, 'double': 64}


class Type:
  """A scalar element type, identified by its DSL name."""

  __slots__ = ('name', 'is_float', 'is_signed', 'width_in_bits', '_exponent')

  def __init__(self, name: str):
    if isinstance(name, Type):  # copy-construct
      name = name.name
    self.name = name
    m = _INT_RE.match(name)
    if m:
      self.is_float = False
      self.is_signed = m.group(1) != 'u'
      self.width_in_bits = int(m.group(2))
      self._exponent = None
      return
    if name in _STD_FLOATS:
      self.is_float = True
      self.is_signed = True
      self.width_in_bits = _STD_FLOATS[name]
      self._exponent = None
      return
    m = _FLOAT_RE.match(name)
    if m:
      self.is_float = True
      self.is_signed = True
      self.width_in_bits = int(m.group(1))
      self._exponent = int(m.group(2)) if m.group(2) else None
      return
    raise ValueError('unknown type: %s' % name)

  # -- identity ------------------------------------------------------------
  def __str__(self) -> str:
    return self.name

  def __repr__(self) -> str:
    return 'Type(%r)' % self.name

  def __eq__(self, other) -> bool:
    if isinstance(other, str):
      return self.name == other
    return isinstance(other, Type) and self.name == other.name

  def __hash__(self) -> int:
    return hash(self.name)

  # -- metrics -------------------------------------------------------------
  @property
  def width_in_bytes(self) -> int:
    return (self.width_in_bits + 7) // 8

  @property
  def is_int(self) -> bool:
    return not self.is_float

  # -- storage mapping -----------------------------------------------------
  @property
  def storage_width(self) -> int:
    """Bit width of the NumPy/JAX dtype used to store this type."""
    if self.is_float:
      if self.width_in_bits <= 16:
        return 16
      if self.width_in_bits <= 32:
        return 32
      return 64
    for w in (8, 16, 32, 64):
      if self.width_in_bits <= w:
        return w
    raise ValueError('integer type too wide: %s' % self.name)

  @property
  def needs_mask(self) -> bool:
    """True if exact-width wrap-around needs masking after each op."""
    return self.is_int and self.width_in_bits != self.storage_width

  @property
  def np_dtype(self) -> np.dtype:
    w = self.storage_width
    if self.is_float:
      return np.dtype('float%d' % w)
    return np.dtype('%sint%d' % ('' if self.is_signed else 'u', w))

  @property
  def jnp_dtype(self):
    # storage dtypes are shared with NumPy; import is deferred so that the
    # IR layer has no hard JAX dependency.
    return self.np_dtype

  def wrap(self, array):
    """Apply exact-width wrap-around semantics to a NumPy array/scalar."""
    if not self.needs_mask:
      return array
    n = self.width_in_bits
    mask = (1 << n) - 1
    v = np.asarray(array).astype(np.int64) & mask
    if self.is_signed:
      sign = 1 << (n - 1)
      v = (v ^ sign) - sign
    return v.astype(self.np_dtype)


@functools.lru_cache(maxsize=None)
def _type(name: str) -> Type:
  return Type(name)


def is_type_name(name: str) -> bool:
  """True if ``name`` lexes as a type (used to disambiguate casts)."""
  return (name in _STD_FLOATS or _INT_RE.match(name) is not None or
          _FLOAT_RE.match(name) is not None)


def common_type(a: Optional[Type], b: Optional[Type]) -> Optional[Type]:
  """Result type of a binary arithmetic op, following C-like conversion.

  Mirrors the coercion the reference inherits from haoda
  (SURVEY.md §2.9 "Arithmetic"): floats dominate ints; wider dominates
  narrower; on equal-width ints, unsigned dominates signed. ``None``
  (an untyped literal) adopts the other operand's type.
  """
  if a is None:
    return b
  if b is None:
    return a
  if a == b:
    return a
  if a.is_float and not b.is_float:
    return a
  if b.is_float and not a.is_float:
    return b
  if a.is_float:  # both float: wider wins; prefer standard names
    if a.width_in_bits == b.width_in_bits:
      return a if a.name in _STD_FLOATS else b
    return a if a.width_in_bits > b.width_in_bits else b
  # both int
  if a.width_in_bits == b.width_in_bits:
    if a.is_signed == b.is_signed:
      return a
    return a if not a.is_signed else b  # unsigned wins at equal width
  return a if a.width_in_bits > b.width_in_bits else b


def common_type_of(types) -> Optional[Type]:
  result = None
  for t in types:
    result = common_type(result, t)
  return result


# Convenience singletons ------------------------------------------------------
FLOAT = Type('float')
DOUBLE = Type('double')
HALF = Type('half')
INT32 = Type('int32')
INT64 = Type('int64')
UINT16 = Type('uint16')
