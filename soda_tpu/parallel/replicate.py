"""Coarse-grain replication: batched execution of independent grids.

The reference's ``replication factor`` duplicates the whole dataflow
pipeline so R tiles stream concurrently (sodac.py:163-171,
core.py:565-614 — throughput scaling when one pipeline cannot use the
memory interface alone). Here that is batching: vmap the executor over
a leading batch axis, so R independent grids ride one launch — the win
is amortized dispatch for small grids, exactly the regime the
reference replicates in.

Cross-device replication is just data parallelism: shard the batch axis
over the first axis of a mesh.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from soda_tpu import utils
from soda_tpu.backend import semantics


class ReplicatedExecutor:
  """Run ``replication_factor`` independent grids per call.

  Inputs/outputs carry a leading batch axis of that extent. An
  ``XlaExecutor`` (built with ``kwargs``, e.g. ``cluster``) is vmapped
  over the batch; with a mesh, the batch axis is sharded across devices
  (each device runs its own grids).
  """

  def __init__(self, stencil, shape: Tuple[int, ...],
               replication_factor: Optional[int] = None,
               mesh=None, **kwargs):
    import jax
    import jax.numpy as jnp
    from soda_tpu.backend.xla import XlaExecutor

    self.stencil = stencil
    self.shape = tuple(shape)
    factor = replication_factor if replication_factor is not None \
        else (stencil.replication_factor or 1)
    if factor < 1:
      raise utils.InputError('replication factor must be >= 1')
    self.replication_factor = factor
    inner = XlaExecutor(stencil, self.shape, **kwargs)
    self.inner = inner
    self.mesh = mesh

    n_in = len(stencil.input_names)
    n_par = len(stencil.param_names)
    # params are shared across replicas: map only the input axes
    batched = jax.vmap(inner.fn, in_axes=(0,) * n_in + (None,) * n_par)
    if mesh is not None:
      from jax.sharding import NamedSharding, PartitionSpec as P
      axis = mesh.axis_names[0]
      # the batch is partitioned over the FIRST mesh axis only
      # (replicated over the rest)
      axis_size = dict(mesh.shape)[axis]
      if factor % axis_size:
        raise utils.InputError(
            "replication factor %d not divisible by mesh axis %r "
            "size %d" % (factor, axis, axis_size))
      self._sharding = NamedSharding(mesh, P(axis))
    else:
      self._sharding = None
    self._fn = jax.jit(batched)
    self._jnp = jnp

  @property
  def fn(self):
    """Jitted callable over batched positional args:
    fn(*inputs[R, ...], *params) -> (outputs[R, ...], ...)."""
    return self._fn

  def prepare(self, inputs: Mapping[str, np.ndarray],
              params: Optional[Mapping[str, np.ndarray]] = None):
    import jax
    jnp = self._jnp
    stencil = self.stencil
    want = (self.replication_factor,) + self.shape
    args = []
    for name in stencil.input_names:
      if name not in inputs:
        raise utils.InputError('missing input: %s' % name)
      arr = jnp.asarray(inputs[name])
      if arr.shape != want:
        raise utils.InputError(
            'replicated input %s shape %s != %s (batch of %d grids)' %
            (name, arr.shape, want, self.replication_factor))
      arr = semantics.wrap(jnp, arr, stencil.symbol_table[name])
      if self._sharding is not None:
        arr = jax.device_put(arr, self._sharding)
      args.append(arr)
    params = dict(params or {})
    for name in stencil.param_names:
      if name not in params:
        raise utils.InputError('missing param: %s' % name)
      args.append(jnp.asarray(params[name]))  # unbatched: vmapped None
    return tuple(args)

  def __call__(self, inputs, params=None) -> Dict[str, np.ndarray]:
    outs = self._fn(*self.prepare(inputs, params))
    return dict(zip(self.stencil.output_names, outs))
