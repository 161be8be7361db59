"""Fusion planning: the analog of the reference's dataflow layer.

The reference lowers a Stencil into an explicit FIFO module graph
(dataflow.py) because its target is a spatial dataflow architecture.
Here all of that machinery collapses into a *fusion plan*: a
chronological stage schedule (one stage per non-input tensor),
per-stage load-offset/margin tables that drive shifted reads, and a
grouping of stages into jitted regions controlled by the ``cluster``
granularity knob (reference cluster.py:51-202 — here a backend fusion
decision rather than an IR rewrite):

  - ``none`` / ``full``: every stage traced into ONE jitted region, so
    XLA may fuse stages where the reference used FIFOs.
  - ``coarse``: one jitted region per stage.
  - ``fine``: accepted and treated as ``coarse``. The reference's fine
    granularity splits each stage per unroll PE id (cluster.py:84-94);
    a jitted region has no schedulable unit below one stage.

Array-axis convention (used by every executor in this package): public
arrays are indexed in REVERSED DSL-dimension order — DSL dimension 0
(the contiguous, stride-1 dimension of the reference's column-major
serialization, soda/util.py:9) is the minor-most (contiguous) array
axis, and the streaming dimension (`*`) is axis 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from soda_tpu import utils
from soda_tpu.core import stencil as core
from soda_tpu.core.tensor import Tensor


def window_margins(stencil, tensor: Tensor
                   ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
  """Margins from the overall stencil window (reference CPU-check loop
  bounds, frt/host.py:566-577). Correct for stencils whose stages all
  normalize their loads, but NOT in general — see materialized_margins."""
  dim = len(stencil.tile_size)
  if tensor.is_input():
    return (0,) * dim, (0,) * dim
  if tensor.is_output():
    sources = tuple(map(stencil.tensors.get, stencil.input_names))
  else:
    sources = tuple(tensor.parents.values())
  return core.window_margins(core.overall_window(tensor, sources))


def materialized_margins(stencil) -> Dict[str, Tuple[Tuple[int, ...],
                                                     Tuple[int, ...]]]:
  """Per-tensor (lo, hi) valid-region margins under grid execution.

  Propagated compositionally through the stage DAG: a cell of tensor T
  is valid iff every load it performs hits a *valid, in-array* cell of
  its parent. This is the true guarantee every executor in this package
  provides (the reference's window-based loop bounds coincide for the
  hand-written corpus, but under computation reuse an intermediate's
  store offset can make the window bound under-estimate the margin —
  its generated host would silently read out of range there).
  """
  cached = getattr(stencil, '_materialized_margins', None)
  if cached is not None:
    return cached
  dim = len(stencil.tile_size)
  zeros = (0,) * dim
  margins: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
      name: (zeros, zeros) for name in stencil.input_names
  }
  for tensor in stencil.chronological_tensors:
    if tensor.is_input():
      continue
    st_idx = tensor.st_idx
    lo = [0] * dim
    hi = [0] * dim
    for parent_name, refs in tensor.ld_refs.items():
      if parent_name in stencil.param_names:
        continue
      p_lo, p_hi = margins[parent_name]
      for ref in refs:
        for d in range(dim):
          delta = ref.idx[d] - st_idx[d]
          lo[d] = max(lo[d], p_lo[d] - delta)
          hi[d] = max(hi[d], p_hi[d] + delta)
    margins[tensor.name] = (tuple(lo), tuple(hi))
  # memoized: the tensor DAG is immutable once built, and the oracle /
  # valid-region helpers query per stage (O(stages^2) otherwise)
  stencil._materialized_margins = margins
  return margins


def stage_margins(stencil, tensor: Tensor
                  ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
  """Valid-region margins of one tensor (see materialized_margins)."""
  return materialized_margins(stencil)[tensor.name]


def validate_grid(stencil, shape: Sequence[int]) -> None:
  """Reject grids too small for the cumulative stencil window.

  Executors otherwise fail deep inside with shape errors (or worse,
  an all-margin output) when some stage's valid region is empty along
  an axis. The reference's generated host rejects undersized tiles up
  front (its tile size is a compile-time constant >= the window);
  here the grid arrives at run time, so check every materialized
  stage. Raises utils.InputError naming the first offending tensor.
  """
  dim = len(stencil.tile_size)
  if len(shape) != dim:
    raise utils.InputError(
        'expected %d-D grid, got %d-D' % (dim, len(shape)))
  for name, (lo, hi) in materialized_margins(stencil).items():
    for d in range(dim):
      # shape is in array-axis (reversed-DSL) order
      extent = shape[dim - 1 - d]
      if lo[d] + hi[d] >= extent:
        raise utils.InputError(
            'grid dimension %d (extent %d) is too small for the '
            'cumulative stencil window of tensor %s '
            '(needs > %d cells)' % (d, extent, name, lo[d] + hi[d]))


@dataclasses.dataclass
class Stage:
  """One producible tensor with its load-offset table."""
  tensor: Tensor
  lo: Tuple[int, ...]  # DSL-dim order
  hi: Tuple[int, ...]
  # parent name -> tuple of load offsets relative to the store index
  # (DSL-dim order); these are the shifts each read applies.
  load_offsets: Dict[str, Tuple[Tuple[int, ...], ...]] = \
      dataclasses.field(default_factory=dict)

  @property
  def name(self) -> str:
    return self.tensor.name

  @property
  def dtype(self):
    return self.tensor.dtype

  def rel_offset(self, ref_idx: Sequence[int]) -> Tuple[int, ...]:
    st = self.tensor.st_idx
    return tuple(i - s for i, s in zip(ref_idx, st))


@dataclasses.dataclass
class FusionPlan:
  """Stage schedule + kernel grouping for one stencil."""
  stencil: object
  stages: List[Stage]
  groups: List[List[Stage]]  # kernels, in execution order
  halo_lo: Tuple[int, ...]  # overall input halo (DSL-dim order)
  halo_hi: Tuple[int, ...]

  @property
  def dim(self) -> int:
    return len(self.halo_lo)

  def stage(self, name: str) -> Stage:
    for s in self.stages:
      if s.name == name:
        return s
    raise KeyError(name)

  def dot(self) -> str:
    """Graphviz dump of the stage DAG (observability parity with the
    reference's SuperSourceNode graphviz hook, dataflow.py:36-41)."""
    lines = ['digraph stages {']
    for name in self.stencil.input_names:
      lines.append('  "%s" [shape=box];' % name)
    for group_id, group in enumerate(self.groups):
      for stage in group:
        lines.append('  "%s" [label="%s\\n%s kernel %d"];' %
                     (stage.name, stage.name, stage.dtype, group_id))
        for parent in stage.tensor.parents:
          lines.append('  "%s" -> "%s";' % (parent, stage.name))
    lines.append('}')
    return '\n'.join(lines)


def make_plan(stencil, cluster: Optional[str] = None) -> FusionPlan:
  """Build the fusion plan for ``stencil``.

  ``cluster`` overrides the stencil's cluster directive; ``none`` and
  ``full`` both mean one jitted region (fusion is the default — the
  reference's ``none`` kept modules separate because FIFOs were free on
  an FPGA; here separate regions round-trip device memory).
  """
  cluster = cluster or stencil.cluster or 'none'
  from soda_tpu.optimization import ranges
  ranges.annotate(stencil)  # enables exact f32 int-division lowering
  margins = materialized_margins(stencil)
  stages: List[Stage] = []
  for tensor in stencil.chronological_tensors:
    if tensor.is_input():
      continue
    lo, hi = margins[tensor.name]
    stage = Stage(tensor=tensor, lo=lo, hi=hi)
    for parent_name, refs in tensor.ld_refs.items():
      stage.load_offsets[parent_name] = tuple(
          stage.rel_offset(ref.idx) for ref in refs)
    stages.append(stage)

  if cluster in ('none', 'full'):
    groups = [list(stages)]
  elif cluster in ('coarse', 'fine'):
    groups = [[s] for s in stages]
  else:
    raise ValueError('unknown cluster granularity: %s' % cluster)

  halo_lo, halo_hi = margins[stencil.output_names[0]]
  for name in stencil.output_names[1:]:
    lo2, hi2 = margins[name]
    halo_lo = tuple(map(max, halo_lo, lo2))
    halo_hi = tuple(map(max, halo_hi, hi2))
  return FusionPlan(stencil=stencil, stages=stages, groups=groups,
                    halo_lo=halo_lo, halo_hi=halo_hi)
