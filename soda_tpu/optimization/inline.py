"""Inlining and reduction rebalancing passes.

Same capabilities as the reference's src/soda/optimization/inline.py:
``inline`` folds locals with exactly one load site into that site;
``inline2`` folds locals consumed by exactly one statement (at any
number of offsets) when the producer itself loads a single ref;
``rebalance`` splits float reductions wider than a threshold into
chained local statements so no single fused expression grows without
bound.

Structured here as a fixpoint over the statement list: each round
recomputes the load-site table, picks an innermost eligible producer
(one that reads no other eligible local — a DAG always has one), and
folds it into its consumer with index-shifted substitution.
"""

from __future__ import annotations

import itertools
import logging
from typing import Callable, Dict, List, Tuple

from soda_tpu.frontend import ast
from soda_tpu.ir import arithmetic, mutator, nodes as ir
from soda_tpu.ir import visitor
from soda_tpu.ir.types import Type

_logger = logging.getLogger().getChild(__name__)


def _all_stmts(stencil):
  return itertools.chain(stencil.local_stmts, stencil.output_stmts)


def _load_sites(stencil) -> Dict[str, List[Tuple[object, List[ir.Ref]]]]:
  """local name -> [(consumer stmt, refs loaded by that stmt), ...]."""
  local_names = {stmt.name for stmt in stencil.local_stmts}
  sites: Dict[str, List[Tuple[object, List[ir.Ref]]]] = {}
  for stmt in _all_stmts(stencil):
    for name, ref_list in visitor.get_load_dict(stmt).items():
      if name in local_names and name != stmt.name:
        sites.setdefault(name, []).append((stmt, list(ref_list)))
  return sites


def _rename_vars(node: ir.Node, renames: Dict[str, str]) -> ir.Node:
  def rename(n, _):
    if isinstance(n, ir.Var) and not n.idx and n.name in renames:
      return ir.Var(name=renames[n.name], idx=(), dtype=n.dtype)
    return n

  return node.visit(rename)


def _fold(producer, consumer, refs: List[ir.Ref]) -> None:
  """Substitute every listed load of ``producer`` inside ``consumer``
  with the producer's expression, shifted to the load's offset.

  Each load site gets its OWN copy of the producer's lets, shifted to
  that site's offset and renamed unique (producer let scopes are per
  statement; a single shared copy would evaluate every site's lets at
  one offset, and unrenamed vars could collide with — and be rebound
  by — the consumer's own lets)."""
  table: Dict[ir.Node, ir.Node] = {}
  hoisted: List[ir.Let] = []
  consumer_lets = {let.name for let in consumer.let}
  # reference parity keeps let names for the common single-site fold
  # (its test asserts the exact folded statement text); renaming is
  # only forced by multiple sites or a consumer-name collision
  must_rename = (len(refs) > 1 or
                 any(let.name in consumer_lets for let in producer.let))
  for site, ref in enumerate(refs):
    delta = tuple(p - r for p, r in zip(producer.ref.idx, ref.idx))
    body = mutator.shift(producer.expr, delta)
    if producer.let:
      renames = {}
      if must_rename:
        renames = {
            let.name: '%s__%s%d' % (let.name, producer.name, site)
            for let in producer.let
        }
      for let in producer.let:
        shifted = mutator.shift(let, delta)
        hoisted.append(
            ir.Let(name=renames.get(let.name, let.name),
                   expr=_rename_vars(shifted.expr, renames),
                   dtype=shifted.dtype))
      body = _rename_vars(body, renames)
    table[mutator.shift(producer.ref, delta)] = body

  def substitute(node, _):
    return table.get(node, node)

  consumer.let = tuple(hoisted) + tuple(
      let.visit(substitute) for let in consumer.let)
  consumer.expr = consumer.expr.visit(substitute)


def _innermost_eligible(stencil, eligible) -> object:
  """An eligible producer reading no other eligible local (exists in
  any DAG); folding it first keeps substitutions self-contained."""
  fallback = None
  for stmt in stencil.local_stmts:
    if stmt.name not in eligible:
      continue
    fallback = fallback or stmt
    reads = {ref.name for ref in visitor.get_load_set(stmt)}
    if not (reads & (eligible - {stmt.name})):
      return stmt
  return fallback


def _run_inline(stencil, pick: Callable, post: Callable):
  changed = False
  while True:
    sites = _load_sites(stencil)
    eligible = {name for name, uses in sites.items() if pick(uses, name)}
    if not eligible:
      break
    producer = _innermost_eligible(stencil, eligible)
    (consumer, refs), = sites[producer.name]
    _logger.info('inlining `%s` into `%s` (%d site%s)', producer.name,
                 consumer.name, len(refs), 's' if len(refs) > 1 else '')
    _fold(producer, consumer, refs)
    stencil.local_stmts.remove(producer)
    changed = True
  if changed:
    _invalidate(stencil)
    for stmt in _all_stmts(stencil):
      stmt.expr = arithmetic.simplify(post(stmt.expr))
      stmt.let = arithmetic.simplify(tuple(map(post, stmt.let)))
  return stencil


def inline(stencil):
  """Fold locals loaded exactly once (one consumer, one offset)."""

  def once(uses, _name):
    return len(uses) == 1 and len(uses[0][1]) == 1

  return _run_inline(stencil, once, lambda expr: expr)


def inline2(stencil):
  """Fold locals consumed by exactly one statement (any number of
  offsets), when the producer loads a single ref; shared coefficients
  are refactored afterwards (reverse distribution)."""
  producer_exprs = {stmt.name: stmt.expr for stmt in stencil.local_stmts}

  def single_consumer(uses, name):
    return (len(uses) == 1 and
            len(visitor.get_load_set(producer_exprs[name])) == 1)

  out = _run_inline(stencil, single_consumer,
                    arithmetic.reverse_distribute)
  return out


# Maximum reduction width before splitting. The reference splits FLOAT
# reductions at 32 to keep HLS codegen tractable (inline.py:170-172);
# here every element type splits at 12. That bound is not tuned for
# XLA: whether splitting helps or hurts its fusion on a GPU is an open
# benchmark question (ROADMAP.md, Speed). Integer splits are exact:
# partial sums compute at the promoted width either way, and the store
# wrap commutes with reassociation.
REBALANCE_THRESHOLD = 12
REBALANCE_THRESHOLDS = {Type('float'): REBALANCE_THRESHOLD}  # legacy alias


def _weighted_terms(expr) -> List[Tuple[object, ir.Node]]:
  """Decompose a '+'-reduction into (coefficient, body) terms, where a
  term like ``(a + b + c) * k`` keeps its inner reduction as the body
  (its width is what rebalancing must bound)."""
  terms = []
  for operand in expr.operand:
    coeff, body = None, operand
    if isinstance(operand, ir.MulDiv) and operand.operator == ('*',):
      left, right = operand.operand
      if isinstance(left, ir.AddSub):
        coeff, body = right, left
      elif isinstance(right, ir.AddSub):
        coeff, body = left, right
    terms.append((coeff, body))
  return terms


def _width(term) -> int:
  coeff, body = term
  return len(body.operand) if coeff is not None else 1


def _rebuild(stencil, group) -> ir.Node:
  operands = tuple(
      body if coeff is None else
      ir.MulDiv(operator=('*',), operand=(body, coeff))
      for coeff, body in group)
  if len(operands) == 1:
    return stencil.propagate_type(operands[0])
  return stencil.propagate_type(
      ir.AddSub(operator=('+',) * (len(operands) - 1), operand=operands))


def rebalance(stencil):
  """Split float reductions wider than the threshold into chained
  locals (widest terms packed first, one spill stmt per extra group)."""
  for stmt in _all_stmts(stencil):
    threshold = REBALANCE_THRESHOLD
    if not isinstance(stmt.expr, ir.AddSub) or \
        set(stmt.expr.operator) != {'+'}:
      continue
    terms = sorted(_weighted_terms(stmt.expr), key=_width, reverse=True)
    groups: List[List] = [[]]
    filled = 0
    for term in terms:
      if filled + _width(term) > threshold and groups[-1]:
        groups.append([])
        filled = 0
      groups[-1].append(term)
      filled += _width(term)
    if len(groups) < 2:
      continue
    _logger.info('splitting %s into %d chained reductions', stmt.name,
                 len(groups))
    spills = []
    for group in groups[:-1]:
      spill_expr = _rebuild(stencil, group)
      spill_dtype = spill_expr.dtype
      if spill_dtype is not None and not spill_dtype.is_float:
        # C accumulates the original (un-split) reduction at the
        # promoted width; a spill declared at the narrow term type
        # would wrap partial sums early and change an output that is
        # declared wider than its terms (int16 taps, int32 store)
        from soda_tpu.backend.semantics import promote
        spill_dtype = promote(spill_dtype)
      spills.append(
          ast.LocalStmt(ref=ir.Ref(name=stencil.new_cr_var(), lat=None,
                                   idx=(0,) * len(stmt.ref.idx)),
                        dtype=spill_dtype, expr=spill_expr,
                        let=stmt.let, stencil=stencil))
    stencil.local_stmts.extend(spills)
    tail = _rebuild(stencil, groups[-1])
    tail_operands = tail.operand if isinstance(tail, ir.AddSub) else (tail,)
    tail_ops = tail.operator if isinstance(tail, ir.AddSub) else ()
    stmt.expr = ir.AddSub(
        operator=tuple(tail_ops) + ('+',) * len(spills),
        operand=tuple(tail_operands) + tuple(s.ref for s in spills))
    _invalidate(stencil)
    return rebalance(stencil)
  return stencil


def _invalidate(stencil):
  stencil.__dict__.pop('symbol_table', None)
  stencil.__dict__.pop('local_names', None)
  stencil.__dict__.pop('local_types', None)
