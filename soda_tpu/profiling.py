"""Profiling & observability helpers.

The reference's profiling surfaces (SURVEY.md §5.1) map here as:

  * generated-host kernel timing / "pixel/ns" printouts
    (xilinx/host.py:798-827)        -> time_per_call() + the CLI's --bench
  * post-HLS csynth reports         -> trace() producing a TensorBoard
    profile via jax.profiler

Device peaks live in ONE table keyed by the exact ``device_kind`` JAX
reports; a device that is not in it is an error, never a default.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, Tuple

import numpy as np

from soda_tpu import utils


@dataclasses.dataclass(frozen=True)
class Peak:
  """Published peak rates of one device."""
  hbm_bytes_per_s: float
  flops_per_s: float  # float32, outside any matrix unit


# NVIDIA H100 SXM5 data sheet: 3.35 TB/s HBM3, 67 TFLOP/s FP32 (the
# CUDA-core rate; stencils use no tensor-core instruction). Rates assume
# the card's full 700 W power limit.
PEAKS = {
    'NVIDIA H100 80GB HBM3': Peak(hbm_bytes_per_s=3.35e12,
                                  flops_per_s=67e12),
}


def peak(device) -> Peak:
  """Peak rates of ``device`` (a jax Device or a device_kind string)."""
  kind = device if isinstance(device, str) else device.device_kind
  if kind not in PEAKS:
    raise utils.InputError(
        'no published peak for device kind %r (known: %s)' %
        (kind, ', '.join(sorted(PEAKS))))
  return PEAKS[kind]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
  """Capture a device profile around a block (view with TensorBoard)."""
  import jax
  jax.profiler.start_trace(log_dir)
  try:
    yield
  finally:
    jax.profiler.stop_trace()


def stream_bytes(stencil, shape) -> Tuple[float, float]:
  """Unique device-memory traffic of one pass (inputs read once,
  outputs written once)."""
  cells = float(np.prod(shape))
  in_b = sum(cells * stencil.symbol_table[n].width_in_bytes
             for n in stencil.input_names)
  out_b = sum(cells * stencil.symbol_table[n].width_in_bytes
              for n in stencil.output_names)
  return in_b, out_b


# calls timed per measurement, after one warm-up call
REPS = 20


def compile_and_time(fn, args, reps: int = REPS):
  """Compile ``jax.jit(fn)`` for ``args`` and time it.

  Returns (compiled, compile_seconds, seconds_per_call); compilation is
  set-up and stays out of the timed calls.
  """
  import jax
  t0 = time.perf_counter()
  compiled = jax.jit(fn).lower(*args).compile()
  compile_s = time.perf_counter() - t0
  return compiled, compile_s, time_per_call(compiled, args, reps)


def time_per_call(fn, args, reps: int = REPS) -> float:
  """Mean wall-clock seconds per call of ``fn(*args)``.

  After one warm-up call, ``reps`` calls are dispatched back to back
  and the clock stops when the last result is ready
  (``block_until_ready``): the host's dispatch of one call overlaps
  the device's work on the previous one, as in a steady stream of
  calls. Blocking on every call would add the host round trip to each
  (measured on an H100 at a 400 W power limit, jacobi2d 8192x8192:
  0.77 ms per call against 0.45 ms of device time in the profiler
  trace).
  """
  import jax
  jax.block_until_ready(fn(*args))
  t0 = time.perf_counter()
  for _ in range(reps):
    out = fn(*args)
  jax.block_until_ready(out)
  return (time.perf_counter() - t0) / reps
