"""Stencil core: the semantic heart of the compiler.

Rebuild of /root/reference/src/soda/core.py (the ``Stencil`` class):
tensor DAG construction with iterate-unrolling (core.py:307-456), the
optimal reuse-buffer scheduling LP (ILP #1, core.py:371-426 — here solved
exactly with scipy's HiGHS; the constraint matrix is a difference system,
so LP relaxation is integral), and overall stencil-window analytics
(the role of core.py:858-926) driving valid-region / halo computation.
The reference's FIFO reuse-chain construction (core.py:684-795) has no
counterpart here — line buffers collapse into shifted whole-array
slices planned by backend/plan.py — and is deliberately absent.
"""

from __future__ import annotations

import collections
import itertools
import logging
from functools import cached_property
from typing import Dict, List, Tuple

import numpy as np

from soda_tpu import utils
from soda_tpu.core.tensor import Tensor
from soda_tpu.ir import arithmetic, nodes as ir
from soda_tpu.ir import visitor as ir_visitor
from soda_tpu.ir.types import Type

_logger = logging.getLogger().getChild(__name__)


class Stencil:
  """See reference core.py:25-51 for the attribute inventory."""

  def __init__(self, **kwargs):
    self.iterate = kwargs.pop('iterate')
    if self.iterate < 1:
      raise utils.SemanticError('cannot iterate %d times' % self.iterate)
    self.border = kwargs.pop('border', None) or 'ignore'
    self.preserve_border = self.border == 'preserve'
    self.cluster = kwargs.pop('cluster', None) or 'none'
    self.burst_width = kwargs.pop('burst_width')
    self.app_name = kwargs.pop('app_name')
    self.tile_size = tuple(kwargs.pop('tile_size'))
    self.unroll_factor = kwargs.pop('unroll_factor')
    self.replication_factor = kwargs.pop('replication_factor', 1)
    self.dim = kwargs.pop('dim', len(self.tile_size))
    self.param_stmts = list(kwargs.pop('param_stmts', ()))
    self.input_stmts = list(kwargs.pop('input_stmts'))
    self.local_stmts = list(kwargs.pop('local_stmts', ()))
    self.output_stmts = list(kwargs.pop('output_stmts'))
    self.optimizations = dict(kwargs.pop('optimizations', {}) or {})

    # dram bank overrides, `name:bank.bank^name:bank` syntax
    # (reference core.py:78-106)
    dram_in = kwargs.pop('dram_in', None)
    if dram_in is not None:
      if ':' in dram_in:
        input_stmt_map = {s.name: s for s in self.input_stmts}
        for dram_map in dram_in.split('^'):
          var_name, bank_list = dram_map.split(':')
          if var_name not in input_stmt_map:
            raise utils.SemanticError('no input named `%s`' % var_name)
          input_stmt_map[var_name].dram = tuple(
              map(int, bank_list.split('.')))
      else:
        for input_stmt in self.input_stmts:
          input_stmt.dram = tuple(map(int, dram_in.split('.')))
    dram_out = kwargs.pop('dram_out', None)
    if dram_out is not None:
      if ':' in dram_out:
        output_stmt_map = {s.name: s for s in self.output_stmts}
        for dram_map in dram_out.split(','):
          var_name, bank_list = dram_map.split(':')
          if var_name not in output_stmt_map:
            raise utils.SemanticError('no output named `%s`' % var_name)
          output_stmt_map[var_name].dram = tuple(
              map(int, bank_list.split('.')))
      else:
        for output_stmt in self.output_stmts:
          output_stmt.dram = tuple(map(int, dram_out.split('.')))
    kwargs.pop('_tx_position', None)

    if self.iterate > 1:
      if len(self.input_stmts) != len(self.output_stmts):
        raise utils.SemanticError(
            'number of input tensors must be the same as output if iterate '
            '> 1 times, currently there are %d input(s) but %d output(s)' %
            (len(self.input_stmts), len(self.output_stmts)))
      if self.input_types != self.output_types:
        raise utils.SemanticError(
            'input must have the same type(s) as output if iterate > 1 '
            'times, current input has type %s but output has type %s' %
            (utils.lst2str(self.input_types),
             utils.lst2str(self.output_types)))

    for stmt in itertools.chain(self.local_stmts, self.output_stmts):
      stmt.stencil = self
      stmt.expr = arithmetic.simplify(stmt.expr)
      stmt.let = arithmetic.simplify(stmt.let)

    # pass pipeline: CR -> inline (opt-in) -> rebalance (reference
    # core.py:134-139); cluster is a backend fusion knob, not an IR
    # pass, and is consumed by soda_tpu.backend.plan.
    self._cr_counter = 0
    from soda_tpu.optimization import computation_reuse as cr
    from soda_tpu.optimization import inline
    if self.optimizations.get('separable', 'yes') != 'no':
      # rank-1 separable factorization of linear stages, BEFORE CR so
      # the 2-D structure is still visible (CR would rewrite the
      # reduction into chains first). Bit-exact for integer stages; a
      # tolerated reassociation for float ones (like rebalance/CR).
      from soda_tpu.optimization import separable
      separable.separable(self)
    cr.computation_reuse(self)
    if 'inline' in self.optimizations:
      inline.inline(self)
    if 'distribute' in self.optimizations:
      # factor shared numeric coefficients: a*c + b*c -> (a + b) * c
      # (reassociation; bit-exact only for ints — floats stay within
      # the reference THRESHOLD)
      for stmt in itertools.chain(self.local_stmts, self.output_stmts):
        stmt.expr = arithmetic.simplify(
            arithmetic.reverse_distribute(stmt.expr))
    inline.rebalance(self)

    for stmt in itertools.chain(self.local_stmts, self.output_stmts):
      stmt.propagate_type()

  def __str__(self) -> str:
    stmts = (self.input_stmts + self.param_stmts + self.local_stmts +
             self.output_stmts)
    return ('kernel: {0.app_name}\nburst width: {0.burst_width}\n'
            'iterate: {0.iterate}\nunroll factor: {0.unroll_factor}\n'
            '{stmts}\nborder: {0.border}\ncluster: {0.cluster}').format(
                self, stmts='\n'.join(map(str, stmts)))

  # -- naming / symbol tables -------------------------------------------------
  @property
  def kernel_name(self) -> str:
    return f'{self.app_name}_kernel'

  def new_cr_var(self) -> str:
    while True:
      var = 'cr_var_%d' % self._cr_counter
      self._cr_counter += 1
      if var not in {
          stmt.name
          for stmt in (self.input_stmts + self.param_stmts +
                       self.local_stmts + self.output_stmts)
      }:
        return var

  @cached_property
  def input_types(self):
    return tuple(s.dtype for s in self.input_stmts)

  @cached_property
  def param_types(self):
    return tuple(s.dtype for s in self.param_stmts)

  @cached_property
  def local_types(self):
    return tuple(s.dtype for s in self.local_stmts)

  @cached_property
  def output_types(self):
    return tuple(s.dtype for s in self.output_stmts)

  @cached_property
  def input_names(self):
    return tuple(s.name for s in self.input_stmts)

  @cached_property
  def param_names(self):
    return tuple(s.name for s in self.param_stmts)

  @cached_property
  def local_names(self):
    return tuple(s.name for s in self.local_stmts)

  @cached_property
  def output_names(self):
    return tuple(s.name for s in self.output_stmts)

  @cached_property
  def symbol_table(self) -> Dict[str, Type]:
    from soda_tpu.ir.types import is_type_name
    symbol_table: Dict[str, Type] = {}
    for name, dtype in zip(
        itertools.chain(self.input_names, self.local_names,
                        self.output_names),
        itertools.chain(self.input_types, self.local_types,
                        self.output_types)):
      if name in symbol_table:
        raise utils.InputError('conflicting stmt name: %s' % name)
      if name in ir.FUNCS or is_type_name(name):
        # a tensor named `min`/`float`/... would be silently parsed
        # as a Call/Cast wherever it is READ; reject at declaration
        raise utils.SemanticError(
            'tensor name %r shadows a built-in function or type' % name)
      symbol_table[name] = dtype
    for stmt in self.param_stmts:
      if stmt.name in symbol_table:
        raise utils.InputError('conflicting stmt name: %s' % stmt.name)
      if stmt.name in ir.FUNCS or is_type_name(stmt.name):
        raise utils.SemanticError(
            'param name %r shadows a built-in function or type' %
            stmt.name)
      symbol_table[stmt.name] = stmt.dtype
    return symbol_table

  @property
  def propagate_type(self):
    """Callable propagating types, optionally with a stmt's let scope
    (reference core.py:258-274)."""

    def propagate_type(node, stmt=None):
      table = self.symbol_table if stmt is None else stmt.symbol_table
      return arithmetic.propagate_type(node, table)

    return propagate_type

  # -- tensor DAG ---------------------------------------------------------------
  def _pipeline_rename(self, iteration: int) -> Dict[str, str]:
    """Name table for pipeline copy ``iteration`` of an iterative
    stencil: inputs/locals of copy k > 0 get an ``_iterK`` suffix, and
    each copy's output IS the next copy's input (the sweeps chain into
    one deeper pipeline — role of reference core.py:320-336); the last
    copy keeps the declared output names. Params are shared across
    copies."""
    suffix = '_iter%d' % iteration
    table = {name: name + suffix if iteration else name
             for name in itertools.chain(self.input_names, self.local_names)}
    if iteration == self.iterate - 1:
      table.update((name, name) for name in self.output_names)
    else:
      # input/output counts match whenever iterate > 1 (ctor-enforced)
      for out_name, in_name in zip(self.output_names, self.input_names):
        table[out_name] = in_name + '_iter%d' % (iteration + 1)
    for name in self.param_names:
      table[name] = name
    return table

  @cached_property
  def tensors(self) -> 'collections.OrderedDict[str, Tensor]':
    """Builds the high-level DAG, unrolling ``iterate`` into a deeper
    pipeline (role of reference core.py:307-456), then solves the
    reuse-offset LP."""
    tensor_map: 'collections.OrderedDict[str, Tensor]' = \
        collections.OrderedDict()
    for stmt in self.input_stmts:
      tensor_map[stmt.name] = Tensor(stmt, self.tile_size)

    for iteration in range(self.iterate):
      renames = self._pipeline_rename(iteration)

      def rename_ref(obj, _):
        if isinstance(obj, ir.Ref):
          if obj.name not in self.symbol_table:
            raise utils.SemanticError(
                'undefined tensor %r referenced (declared names: %s)' %
                (obj.name, ', '.join(sorted(self.symbol_table))))
          obj.dtype = self.symbol_table[obj.name]
          obj.name = renames[obj.name]  # noqa: B023
        return obj

      copies = [Tensor(stmt.visit(rename_ref), self.tile_size)
                for stmt in itertools.chain(self.local_stmts,
                                            self.output_stmts)]
      tensor_map.update((t.name, t) for t in copies)
      for tensor in copies:
        tensor.propagate_type()
        self._wire_edges(tensor, tensor_map)

    self._solve_reuse_offsets(tensor_map)
    return tensor_map

  def _wire_edges(self, tensor: Tensor, tensor_map) -> None:
    """Connect ``tensor`` to the producers it loads from, recording the
    load refs in serialized order."""
    for parent_name, ld_refs in ir_visitor.get_load_dict(tensor).items():
      if parent_name in self.param_names:
        continue  # params are broadcast, not streamed
      parent = tensor_map[parent_name]
      parent.children[tensor.name] = tensor
      tensor.parents[parent_name] = parent
      tensor.ld_refs[parent_name] = sorted(
          ld_refs, key=lambda ref: utils.serialize(ref.idx, self.tile_size))

  def _solve_reuse_offsets(self, tensor_map) -> None:
    """ILP #1: optimal reuse-buffer offsets (reference core.py:371-426).

    Variables: produced_T (p) and consumed_T (q) per tensor; minimize
    total reuse distance sum(q - p) subject to
      q_T >= p_T
      p_ld <= p_st + (st_offset - newest_access)   per DAG edge
      q_ld >= p_st + (st_offset - oldest_access)   per DAG edge
    The constraint matrix is a difference system, so the LP optimum is
    integral; solved with scipy HiGHS.
    """
    from scipy.optimize import linprog

    names = list(tensor_map)
    n = len(names)
    index = {name: i for i, name in enumerate(names)}
    # x = [p_0..p_{n-1}, q_0..q_{n-1}]
    c = np.zeros(2 * n)
    c[:n] = -1.0
    c[n:] = 1.0
    a_ub: List[np.ndarray] = []
    b_ub: List[float] = []

    def add_le(coeffs, bound):  # sum(coeff*x) <= bound
      row = np.zeros(2 * n)
      for var, co in coeffs:
        row[var] += co
      a_ub.append(row)
      b_ub.append(float(bound))

    for name in names:
      i = index[name]
      add_le([(i, 1.0), (n + i, -1.0)], 0.0)  # p_T - q_T <= 0
    for st in tensor_map.values():
      for ld_name, offsets in st.ld_offsets.items():
        oldest, newest = min(offsets), max(offsets)
        i_ld, i_st = index[ld_name], index[st.name]
        add_le([(i_ld, 1.0), (i_st, -1.0)], st.st_offset - newest)
        add_le([(i_st, 1.0), (n + i_ld, -1.0)], -(st.st_offset - oldest))

    bounds = [(None, None)] * (2 * n)
    bounds[index[self.input_names[0]]] = (0, 0)  # reference point
    res = linprog(c, A_ub=np.array(a_ub), b_ub=np.array(b_ub),
                  bounds=bounds, method='highs')
    if not res.success:
      raise utils.InternalError('unexpected LP status: %s' % res.message)
    p = np.rint(res.x[:n]).astype(int)
    q = np.rint(res.x[n:]).astype(int)
    total_distance = int((q - p).sum())
    _logger.info('total reuse distance: %d', total_distance)
    self.total_reuse_distance = total_distance

    base = min(p[index[name]] for name in self.input_names)
    for name, tensor in tensor_map.items():
      tensor.produce_offset = int(p[index[name]] - base)
      tensor.consume_offset = int(q[index[name]] - base)
      tensor.max_access = 0
    for ld in tensor_map.values():
      for st in ld.children.values():
        oldest_access = (st.st_offset - min(st.ld_offsets[ld.name]) +
                         st.produce_offset - ld.produce_offset)
        ld.max_access = max(ld.max_access, oldest_access)

  @cached_property
  def chronological_tensors(self) -> List[Tensor]:
    return list(
        map(
            self.tensors.get,
            utils.toposort_flatten(
                {
                    t.name: set(t.parents)
                    for t in self.tensors.values()
                },
                sort=False)))

  # -- stencil window analytics -------------------------------------------------
  @cached_property
  def stencil_window(self) -> Tuple[Tuple[int, ...], ...]:
    """Overall (transitive) read window of the first output w.r.t. the
    inputs, offsets relative to the output cell."""
    return overall_window(
        self.tensors[self.output_names[0]],
        [self.tensors[name] for name in self.input_names])

  @cached_property
  def stencil_distance(self) -> int:
    """Number of input elements the pipeline must retain: newest
    serialized read plus the low-corner anchor displacement (the
    reference's line-buffer size, README.md:155-156; never less than
    the newest read alone, for windows entirely ahead of the anchor).
    0 for outputs that read no input (constant / param-only)."""
    if not self.stencil_window:
      return 0
    newest = max(
        utils.serialize_iter(self.stencil_window, self.tile_size))
    anchor = utils.serialize(window_offset(self.stencil_window),
                             self.tile_size)
    return max(newest + anchor, newest)

  @property
  def meta_lines(self) -> Tuple[str, ...]:
    return (
        '# this program can be generated from the following SODA DSL',
        '"""\n%s\n"""' % self,
        '',
        '# stencil window size: %s' %
        (tuple(window_extent(self.stencil_window)),),
        '# stencil distance: %s' % self.stencil_distance,
        '',
    )


# -- stencil window math ----------------------------------------------------------
#
# The overall window drives halo sizing, valid-region computation and
# the ``stencil distance`` diagnostic (the same quantities the
# reference derives at core.py:858-926 for host padding). Computed here
# as a worklist walk over (tensor, accumulated offset) states instead
# of per-source recursion: starting from one output cell, follow every
# load edge backward, accumulating the relative displacement, and
# collect the displacements at which a source tensor is read.


def overall_window(tensor: Tensor, sources) -> Tuple[Tuple[int, ...], ...]:
  """All cells of ``sources`` (offsets relative to one ``tensor`` cell)
  that computing that cell transitively reads."""
  wanted = {t.name for t in sources}
  start = (0,) * len(tensor.st_idx)
  seen = {(tensor.name, start)}
  todo = [(tensor, start)]
  window = set()
  while todo:
    t, at = todo.pop()
    if t.name in wanted:
      window.add(at)
    for parent_name, refs in t.ld_refs.items():
      parent = t.parents[parent_name]
      for ref in refs:
        # a load of parent(ref.idx) while storing t(st_idx) displaces
        # the coordinate frame by their difference
        hop = tuple(a + r - s for a, r, s in zip(at, ref.idx, t.st_idx))
        state = (parent_name, hop)
        if state not in seen:
          seen.add(state)
          todo.append((parent, hop))
  return tuple(sorted(window))


def window_extent(window) -> List[int]:
  """Per-dimension size of the window's bounding box (empty window:
  no axes — callers treat it as a degenerate point)."""
  return [max(axis) - min(axis) + 1 for axis in zip(*window)]


def window_offset(window) -> Tuple[int, ...]:
  """Displacement from the window's low corner to the anchor cell."""
  return tuple(-min(axis) for axis in zip(*window))


def window_margins(window) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
  """(lo, hi) border widths a window implies, per dimension."""
  lo = tuple(max(0, -min(axis)) for axis in zip(*window))
  hi = tuple(max(0, max(axis)) for axis in zip(*window))
  return lo, hi


