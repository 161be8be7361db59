"""Execution backends.

- reference: NumPy oracle (C semantics, the correctness gold standard)
- xla:       whole-grid jitted stages (plain jnp slice arithmetic that
             XLA compiles for whatever device JAX runs on)
- get_executor: dispatch by backend name
"""

from __future__ import annotations

from typing import Tuple

from soda_tpu import utils

# Configuration of the retired fused Mosaic kernel. Passing one is an
# error rather than a silent no-op, so old call sites fail loudly.
RETIRED_KERNEL_OPTIONS = frozenset((
    'block_rows', 'stage_mode', 'shift_mode', 'lane_shift',
    'transpose_lanes', 'stream_loop', 'prefetch', 'dma_split', 'mid_tile',
    'narrow', 'compute_chunk'))


def get_executor(stencil, shape: Tuple[int, ...], backend: str = 'auto',
                 **kwargs):
  """Build an executor: 'xla' (also what 'auto' picks), 'sharded' or
  'replicated'."""
  retired = sorted(RETIRED_KERNEL_OPTIONS.intersection(kwargs))
  if backend == 'pallas' or retired:
    raise utils.InputError(
        'the fused Pallas kernel and its options (%s) were removed; the '
        "XLA executor ('auto' or 'xla') runs every stencil" %
        (', '.join(retired) or "backend='pallas'"))
  if backend in ('auto', 'xla'):
    from soda_tpu.backend.xla import XlaExecutor
    return XlaExecutor(stencil, shape, **kwargs)
  if backend == 'sharded':
    from soda_tpu.parallel.spmd import ShardedExecutor
    return ShardedExecutor(stencil, shape, **kwargs)
  if backend == 'replicated':
    # coarse-grain replication: R independent grids batched through
    # one launch (the reference's replication_factor, core.py:565-614)
    from soda_tpu.parallel.replicate import ReplicatedExecutor
    return ReplicatedExecutor(stencil, shape, **kwargs)
  raise ValueError('unknown backend: %s' % backend)
