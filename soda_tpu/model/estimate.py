"""Analytic roofline estimate for stencil execution.

The analog of the reference's pre-synthesis estimator
(/root/reference/src/soda/model/xilinx.py:34-196): where that model caps
throughput at DRAM bandwidth (`performance = unroll_factor x
target_freq`, capped by `dram_bandwidth x banks / bytes-per-pixel`,
model/xilinx.py:131-144), this one computes, device-neutrally,

  * device-memory traffic per pass (inputs read once + outputs written
    once),
  * arithmetic operations per cell over the post-unroll, post-reuse
    stage schedule,

and divides them by a device's published peaks: the roofline time is
the larger of bytes / bandwidth and operations / peak rate, and the
report says which of the two binds.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np

from soda_tpu.backend.plan import make_plan
from soda_tpu.ir import nodes as ir


def _count_ops_into(counts: Dict[str, float], *nodes) -> None:
  """Accumulate arithmetic op counts of expression trees."""

  def visit(node, _):
    if isinstance(node, ir.AddSub):
      counts['add'] += len(node.operator)
    elif isinstance(node, ir.MulDiv):
      for op in node.operator:
        counts['mul' if op == '*' else 'div'] += 1
    elif isinstance(node, ir.Call):
      if node.name in ('min', 'max'):
        counts['minmax'] += len(node.operand) - 1
      elif node.name in ('select', 'abs'):
        counts['other'] += 1
      else:
        counts['transcendental'] += 1
    return node

  for node in nodes:
    node.visit(visit)


def _zero_counts() -> Dict[str, float]:
  return {'add': 0, 'mul': 0, 'div': 0, 'minmax': 0,
          'transcendental': 0, 'other': 0}


def count_ops(stencil) -> Dict[str, float]:
  """Per-output-cell operation counts of the declared statements."""
  counts = _zero_counts()
  for stmt in stencil.local_stmts + stencil.output_stmts:
    _count_ops_into(counts, stmt.expr, *stmt.let)
  return counts


def op_counts(stencil) -> Dict[str, float]:
  """Per-cell operation counts over the executed stage schedule: every
  ``iterate`` sweep and every computation-reuse variable included."""
  counts = _zero_counts()
  for stage in make_plan(stencil, 'full').stages:
    _count_ops_into(counts, stage.tensor.expr, *stage.tensor.lets)
  return counts


def estimate(stencil, shape: Tuple[int, ...], device=None,
             model_params: Optional[Dict[str, float]] = None
             ) -> Dict[str, object]:
  """Roofline estimate of one application on ``device`` (a jax Device
  or device_kind string, looked up in soda_tpu.profiling.PEAKS).

  ``model_params`` replaces the table lookup ({'name': .., 'hbm_gbps':
  .., 'gflops': ..} — the analog of the reference's --model-file JSON
  with target_freq/dram_bandwidth, model/xilinx.py:34-60).
  """
  from soda_tpu.profiling import peak, stream_bytes
  if model_params:
    kind = model_params.get('name', 'model-file')
    bw = float(model_params['hbm_gbps']) * 1e9
    flops = float(model_params['gflops']) * 1e9
  else:
    kind = device if isinstance(device, str) else device.device_kind
    p = peak(kind)
    bw, flops = p.hbm_bytes_per_s, p.flops_per_s
  plan = make_plan(stencil, 'full')
  cells = float(np.prod(shape))
  in_bytes, out_bytes = stream_bytes(stencil, shape)
  traffic = in_bytes + out_bytes
  ops = op_counts(stencil)
  ops_per_cell = float(sum(ops.values()))
  memory_s = traffic / bw
  compute_s = ops_per_cell * cells / flops
  time_s = max(memory_s, compute_s)
  return {
      'device': kind,
      'peak_hbm_gbps': bw / 1e9,
      'peak_gflops': flops / 1e9,
      'cells': cells,
      'hbm_bytes': traffic,
      'ops_per_cell': ops,
      'flops_per_cell': ops_per_cell,
      'arithmetic_intensity': ops_per_cell * cells / traffic,
      'bound': 'memory' if memory_s >= compute_s else 'compute',
      'memory_time_s': memory_s,
      'compute_time_s': compute_s,
      'roofline_time_s': time_s,
      'roofline_cells_per_s': cells * stencil.iterate / time_s,
      'halo': {'lo': plan.halo_lo, 'hi': plan.halo_hi},
      'stages': len(plan.stages),
      'total_reuse_distance': getattr(stencil, 'total_reuse_distance', None),
  }


def print_estimation(stencil, shape, file, device=None,
                     model_params=None) -> None:
  json.dump(estimate(stencil, shape, device, model_params),
            file, indent=2, default=str)
  file.write('\n')
