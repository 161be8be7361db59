"""XLA whole-grid executor: stencil stages as fused jnp slice arithmetic.

The replacement for the reference's generated HLS kernel + host pair:
every stage of the fusion plan becomes shifted static slices of its
parents plus elementwise arithmetic, all traced into one ``jax.jit``
region per kernel group so XLA fuses the multi-stage pipeline into as
few device-memory passes as it can. (The reference's FIFO network
between modules — dataflow.py:336-625 — is what XLA fusion replaces.)
This is the single-device executor on every platform.

Semantics are identical to the NumPy oracle: same Evaluator (C
arithmetic), same per-stage valid regions with zero margins.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from soda_tpu import utils
from soda_tpu.backend import semantics
from soda_tpu.backend.plan import (FusionPlan, make_plan,
                                   validate_grid)
from soda_tpu.ir import nodes as ir


def _stage_compute(stencil, stage, arrays, params, shape, jnp):
  """Produce one stage's full-grid array from its parents."""
  dim = len(shape)
  lo, hi = stage.lo, stage.hi
  region = tuple(
      slice(lo[dim - 1 - a], shape[a] - hi[dim - 1 - a]) for a in range(dim))
  st_idx = stage.tensor.st_idx

  def load(ref: ir.Ref):
    if ref.name in stencil.param_names:
      return params[ref.name][tuple(ref.idx)]
    src = arrays[ref.name]
    window = tuple(
        slice(region[a].start + ref.idx[dim - 1 - a] - st_idx[dim - 1 - a],
              region[a].stop + ref.idx[dim - 1 - a] - st_idx[dim - 1 - a])
        for a in range(dim))
    return src[window]

  def param(name, idx):
    return params[name][idx]

  evaluator = semantics.Evaluator(jnp, load, param=param, fast_rsqrt=True,
                                  fast_int_div=True)
  value, _ = evaluator.eval_stmt(stage.tensor)
  value = semantics.wrap(jnp, value, stage.dtype)
  pad = tuple((lo[dim - 1 - a], hi[dim - 1 - a]) for a in range(dim))
  if any(p != (0, 0) for p in pad):
    value = jnp.pad(value, pad)
  return value


def forward(stencil, arrays: Dict, params: Dict, shape: Tuple[int, ...],
            plan: Optional[FusionPlan] = None) -> Dict:
  """Trace all stages over full-grid arrays; returns {output: array}.

  Pure traceable function (no jit) — reused by the sharded executor to
  run per-device local computation inside shard_map.
  """
  import jax.numpy as jnp
  plan = plan or make_plan(stencil, 'full')
  arrays = dict(arrays)
  for stage in plan.stages:
    arrays[stage.name] = _stage_compute(stencil, stage, arrays, params,
                                        shape, jnp)
  return {name: arrays[name] for name in stencil.output_names}


class XlaExecutor:
  """Compile a stencil to jitted XLA for a fixed grid shape.

  Args:
    stencil: a core.Stencil.
    shape: full array shape (array-axis order, streaming axis first).
    cluster: fusion granularity override; ``none``/``full`` trace all
      stages into one jit, ``coarse``/``fine`` jit each stage
      separately (one device-memory handoff per stage).
  """

  def __init__(self, stencil, shape: Tuple[int, ...],
               cluster: Optional[str] = None):
    import jax
    import jax.numpy as jnp
    self.stencil = stencil
    self.shape = tuple(shape)
    validate_grid(stencil, self.shape)
    semantics.require_f64_support(stencil)
    self.plan: FusionPlan = make_plan(stencil, cluster)
    self._jnp = jnp
    self._group_fns = []
    for group in self.plan.groups:
      fn = functools.partial(self._run_group, tuple(s.name for s in group))
      self._group_fns.append(jax.jit(fn))

  def _run_group(self, stage_names, arrays: Dict, params: Dict) -> Dict:
    jnp = self._jnp
    arrays = dict(arrays)
    produced = {}
    by_name = {s.name: s for s in self.plan.stages}
    for name in stage_names:
      stage = by_name[name]
      value = _stage_compute(self.stencil, stage, arrays, params,
                             self.shape, jnp)
      arrays[name] = value
      produced[name] = value
    return produced

  @property
  def fn(self):
    """Jittable positional callable: fn(*inputs, *params) ->
    (outputs...), the contract the replication and chained drivers
    compose with; prepare arguments with ``prepare``."""
    stencil = self.stencil
    n_in = len(stencil.input_names)

    def run(*args):
      arrays = dict(zip(stencil.input_names, args[:n_in]))
      params = dict(zip(stencil.param_names, args[n_in:]))
      for fn in self._group_fns:
        arrays.update(fn(arrays, params))
      outs = {name: arrays[name] for name in stencil.output_names}
      if stencil.preserve_border:
        from soda_tpu.backend.reference import preserve_border_fixup
        outs = preserve_border_fixup(self._jnp, stencil, self.shape,
                                     lambda n: arrays[n], outs)
      return tuple(outs[name] for name in stencil.output_names)

    return run

  def prepare(self, inputs: Mapping[str, np.ndarray],
              params: Optional[Mapping[str, np.ndarray]] = None):
    """Wrap + device-put arguments (positional order for ``fn``)."""
    import jax
    jnp = self._jnp
    stencil = self.stencil
    args = []
    for name in stencil.input_names:
      if name not in inputs:
        raise utils.InputError('missing input: %s' % name)
      arr = jnp.asarray(inputs[name])
      if arr.shape != self.shape:
        raise utils.InputError('input %s shape %s != compiled shape %s' %
                               (name, arr.shape, self.shape))
      args.append(jax.device_put(
          semantics.wrap(jnp, arr, stencil.symbol_table[name])))
    params = dict(params or {})
    for name in stencil.param_names:
      if name not in params:
        raise utils.InputError('missing param: %s' % name)
      args.append(jax.device_put(jnp.asarray(params[name])))
    return tuple(args)

  def __call__(self,
               inputs: Mapping[str, np.ndarray],
               params: Optional[Mapping[str, np.ndarray]] = None
               ) -> Dict[str, np.ndarray]:
    outs = self.fn(*self.prepare(inputs, params))
    return dict(zip(self.stencil.output_names, outs))
