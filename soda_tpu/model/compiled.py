"""Compiled-kernel statistics: the csynth-report analog.

Where the reference reads Vivado HLS csynth reports after synthesis to
learn real resource usage and pipeline depths (rtl_kernel.py:76-95,
model/resource.py), the analog here interrogates the XLA-compiled
executable: FLOP counts, bytes accessed, and per-memory-space peak
usage.
"""

from __future__ import annotations

from typing import Dict, Optional


def compiled_stats(executor, inputs, params=None) -> Dict[str, object]:
  """Lower + compile the executor's jitted fn and report XLA's own
  cost/memory analysis."""
  import jax
  args = executor.prepare(inputs, params)
  lowered = jax.jit(lambda *a: executor.fn(*a)).lower(*args)
  compiled = lowered.compile()
  out: Dict[str, object] = {}
  try:
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
      cost = cost[0] if cost else {}
    out['flops'] = cost.get('flops')
    out['bytes_accessed'] = cost.get('bytes accessed',
                                     cost.get('bytes_accessed'))
    out['transcendentals'] = cost.get('transcendentals')
  except Exception as e:  # noqa: BLE001 - backend-dependent API
    out['cost_analysis_error'] = repr(e)
  try:
    mem = compiled.memory_analysis()
    for key in ('temp_size_in_bytes', 'argument_size_in_bytes',
                'output_size_in_bytes', 'generated_code_size_in_bytes'):
      out[key] = getattr(mem, key, None)
  except Exception as e:  # noqa: BLE001
    out['memory_analysis_error'] = repr(e)
  return out
