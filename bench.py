"""Time one application of every corpus kernel on one GPU.

Usage: python bench.py

For each corpus kernel at its device grid (soda_tpu.corpus.DEVICE_DIMS)
this builds the executor ``get_executor`` picks, compiles it (reported
as set-up time) and times one application: after one warm-up call,
``profiling.REPS`` calls are issued back to back and the clock stops
when the last result is ready (``profiling.time_per_call``), so the
host's round trip per call stays out of the figure. The roofline share
divides the analytic bound (soda_tpu.model.estimate: the larger of
bytes over peak bandwidth and operations over peak rate, from the one
table of device peaks) by that time. Prints one JSON line. Exits
non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import json
import pathlib
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parent
if str(REPO_ROOT) not in sys.path:
  sys.path.insert(0, str(REPO_ROOT))

from soda_tpu import profiling  # noqa: E402


def kernel_row(name, shape, device, reps: int = profiling.REPS):
  """Compile and time one corpus kernel at ``shape`` on ``device``."""
  from soda_tpu import corpus
  from soda_tpu.backend import get_executor, reference
  from soda_tpu.model.estimate import estimate

  stencil = corpus.build_for_grid(name, shape)
  executor = get_executor(stencil, shape)
  args = executor.prepare(reference.make_test_inputs(stencil, shape),
                          reference.make_test_params(stencil))
  _, compile_s, dt = profiling.compile_and_time(executor.fn, args, reps)
  est = estimate(stencil, shape, device)
  return {
      'shape': list(shape),
      'ms': dt * 1e3,
      'compile_s': compile_s,
      'roofline_share': est['roofline_time_s'] / dt,
      'bound': est['bound'],
      'hbm_gbps': est['hbm_bytes'] / dt / 1e9,
  }


def main() -> int:
  import jax
  from soda_tpu import cache, corpus
  cache.enable()
  device = jax.devices()[0]
  if device.platform != 'gpu':
    print('bench: needs a GPU, JAX found %s' % device.platform,
          file=sys.stderr)
    return 1
  rows = {name: kernel_row(name, shape, device)
          for name, shape in sorted(corpus.DEVICE_DIMS.items())}
  print(json.dumps({
      'device': {'platform': device.platform, 'kind': device.device_kind,
                 'count': len(jax.devices())},
      'kernels': rows}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
