"""Multi-device stencil execution: mesh sharding + halo exchange.

The replacement for the reference's multi-DRAM-bank data partitioning
and host-side halo-overlapped tiling (reference docs/data-layout.md:62-255,
codegen/xilinx/host.py:641-701): the grid is sharded over a 1-D or 2-D
device mesh via ``jax.shard_map`` (streaming axis, and optionally the
next array axis); each step exchanges halo slabs with mesh neighbors
using ``lax.ppermute`` (collective permutes that XLA hands to the
device interconnect) and runs the local stencil pipeline on its
extended shard. Halo width is the OVERALL stencil reach (transitive
input->output), so multi-stage and iterate>1 kernels exchange once per
step, not once per stage. The exchange is two-phase (axis 0, then
axis 1 over the already-extended shard), which transports corner halos
for diagonal stencil taps.

Devices at the global boundary receive zero halos (ppermute's
non-participating edge), which lands only in the globally-invalid
border region — identical semantics to the single-chip executors.
Extents that do not divide the mesh are padded to a shard multiple and
cropped back; ``border: preserve`` is applied inside the shard_map with
the TRUE global boundary derived from each shard's mesh position.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from soda_tpu import utils
from soda_tpu.backend import semantics
from soda_tpu.backend.plan import make_plan


class ShardedExecutor:
  """Run a stencil over a device mesh.

  Args:
    stencil: a core.Stencil.
    global_shape: full grid shape (array-axis order).
    mesh: a jax.sharding.Mesh; mesh axis k shards array axis k (1 or
      2 sharded array axes). Default mesh: all devices on one axis
      ('x').
    overlap: 'off' (default) or 'on' — overlap the halo exchange with
      interior compute. 'on' issues the ppermutes FIRST, computes the
      halo-INDEPENDENT interior of the shard while they fly, then
      computes only the two edge bands from the received halos and
      stitches (single sharded axis). This is the analog of the
      reference's FIFO-depth ILP, whose whole point is keeping
      communication pipelined under compute
      (reference dataflow.py:94-176): the step latency model improves
      from compute(local) + halo latency to
      max(compute(interior), halo latency) + compute(edge bands) —
      the exchange disappears from the critical path whenever the
      interior (local_rows - halo rows of work) outlasts the wire,
      at the price of re-computing the overall-halo margin inside
      each edge band (2*(lo+hi) extra rows of work per shard).
      tests/test_spmd.py verifies the structure in the jaxpr: the
      interior chain is reachable without any ppermute output.
  """

  def __init__(self, stencil, global_shape: Tuple[int, ...],
               mesh=None, overlap: str = 'off'):
    import jax
    from jax import lax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    self.stencil = stencil
    self.shape = tuple(global_shape)
    semantics.require_f64_support(stencil)
    self.plan = make_plan(stencil, 'full')
    dim = self.plan.dim
    if mesh is None:
      devices = np.array(jax.devices())
      # DSL `dram` bank annotations are the reference's data-parallel
      # width request (docs/data-layout.md:62-127: elements cyclically
      # partitioned over banks); the mesh-sharding analog is the
      # default shard count. Multiple declared banks pick that many
      # devices for the default 1-D mesh (capped at what exists); an
      # explicit `mesh=` always wins.
      n_banks = max((len(getattr(stmt, 'dram', ()) or ())
                     for stmt in stencil.input_stmts + stencil.output_stmts),
                    default=1)
      if n_banks > 1:
        devices = devices[:n_banks]
      mesh = Mesh(devices, ('x',))
    axes = tuple(mesh.axis_names)
    if not 1 <= len(axes) <= 2:
      raise utils.InputError(
          'ShardedExecutor shards 1 or 2 array axes')
    if len(axes) > dim:
      raise utils.InputError(
          '%d sharded axes need a grid with at least as many dimensions' %
          len(axes))
    self.mesh = mesh
    self._axes = axes

    # per sharded array axis: mesh extent, local extent, halo widths.
    # Indivisible extents are padded up to a shard multiple (the analog
    # of the reference host's aligned tile sizes, host.py:641-701) and
    # outputs cropped back; padding lands beyond the original grid so
    # valid cells never read it.
    mesh_shape = dict(mesh.shape)
    padded = list(self.shape)
    halos = []
    for a, name in enumerate(axes):
      padded[a] += (-self.shape[a]) % mesh_shape[name]
    self.padded_shape = tuple(padded)
    local = list(self.padded_shape)
    for a, name in enumerate(axes):
      n_dev = mesh_shape[name]
      local[a] = self.padded_shape[a] // n_dev
      d = dim - 1 - a
      lo, hi = self.plan.halo_lo[d], self.plan.halo_hi[d]
      if (lo or hi) and (lo >= local[a] or hi >= local[a]):
        raise utils.InputError(
            'halo (%d, %d) exceeds local extent %d on axis %d' %
            (lo, hi, local[a], a))
      halos.append((lo, hi, n_dev, name))

    ext_shape = tuple(
        local[a] + (halos[a][0] + halos[a][1] if a < len(axes) else 0)
        for a in range(dim))
    stencil_ref = stencil
    plan = self.plan
    input_names = stencil.input_names
    param_names = stencil.param_names
    output_names = stencil.output_names

    from soda_tpu.backend import xla as xla_backend

    def run_local(arrays: Dict, params: Dict) -> Dict:
      # the overlap path calls on interior/edge-band extents, not the
      # halo-extended shard — forward slices with the shape it is
      # TOLD, so derive it from the actual arrays every time
      shp = next(iter(arrays.values())).shape
      return xla_backend.forward(stencil_ref, arrays, params,
                                 tuple(shp), plan)

    def exchange(array, axis_idx):
      """Extend ``array`` along axis ``axis_idx`` with neighbor halos
      (width = the plan-wide overall halo, identical for all inputs)."""
      lo, hi, n_dev, axis_name = halos[axis_idx]
      fwd = [(i, i + 1) for i in range(n_dev - 1)]
      bwd = [(i + 1, i) for i in range(n_dev - 1)]
      parts = []
      sl_lo = [slice(None)] * array.ndim
      sl_hi = [slice(None)] * array.ndim
      if lo:
        sl_lo[axis_idx] = slice(-lo, None)
        parts.append(lax.ppermute(array[tuple(sl_lo)], axis_name, fwd))
      parts.append(array)
      if hi:
        sl_hi[axis_idx] = slice(0, hi)
        parts.append(lax.ppermute(array[tuple(sl_hi)], axis_name, bwd))
      if len(parts) == 1:
        return array
      return jnp.concatenate(parts, axis=axis_idx)

    # per-output margins come from the SAME plan the executors use
    # (Stage.lo/hi are materialized_margins verbatim, plan.py)
    out_margins = {
        name: (plan.stage(name).lo, plan.stage(name).hi)
        for name in output_names
    }
    real_shape = self.shape
    n_outputs = len(output_names)

    def valid_mask(name):
      """Boolean mask of this shard's cells inside the GLOBAL valid
      region of output ``name`` (border: preserve under sharding needs
      the global boundary, not the shard's; the shard's global offset
      comes from its mesh position)."""
      m_lo, m_hi = out_margins[name]
      mask = None
      for a in range(dim):
        d = dim - 1 - a
        lo_a, hi_a = m_lo[d], m_hi[d]
        base = 0
        if a < len(axes):
          base = lax.axis_index(axes[a]) * local[a]
        pos = base + lax.broadcasted_iota(jnp.int32, tuple(local), a)
        ok = jnp.logical_and(pos >= lo_a, pos < real_shape[a] - hi_a)
        mask = ok if mask is None else jnp.logical_and(mask, ok)
      return mask

    if overlap not in ('off', 'on'):
      raise utils.InputError("overlap must be 'off' or 'on'")
    if overlap == 'on' and len(axes) != 1:
      raise utils.InputError('overlap applies to single-axis sharding')
    if overlap == 'on' and halos[0][0] + halos[0][1] > local[0]:
      raise utils.InputError(
          'overlap needs local extent %d > total halo %d (edge bands '
          'would cover the whole shard); use overlap=off' %
          (local[0], halos[0][0] + halos[0][1]))
    self.overlap = overlap

    def step_overlapped(locals_in: Dict, params: Dict):
      """Issue halo permutes, compute the interior while they fly,
      then the edge bands, and stitch. Outputs are local-extent."""
      lo, hi, n_dev, axis_name = halos[0]
      fwd = [(i, i + 1) for i in range(n_dev - 1)]
      bwd = [(i + 1, i) for i in range(n_dev - 1)]
      # 1. the sends: no downstream op before these in the graph
      recv_lo = {name: lax.ppermute(arr[-lo:], axis_name, fwd)
                 for name, arr in locals_in.items()} if lo else None
      recv_hi = {name: lax.ppermute(arr[:hi], axis_name, bwd)
                 for name, arr in locals_in.items()} if hi else None
      # 2. interior: depends ONLY on the local shard, so XLA's
      # latency-hiding scheduler runs it between permute-start and
      # permute-done (structurally pinned by test_spmd.py)
      interior = run_local(locals_in, params)
      L = local[0]
      pieces = {name: [] for name in output_names}
      # 3. edge bands: the received halo + a margin-deep strip of the
      # local shard; band outputs are valid on their center rows
      # because every output's margins are <= the plan-wide halo
      if lo:
        band = {name: jnp.concatenate(
            [recv_lo[name], arr[:lo + hi]], axis=0)
            for name, arr in locals_in.items()}
        low = run_local(band, params)
        for name in output_names:
          pieces[name].append(low[name][lo:2 * lo])
      for name in output_names:
        pieces[name].append(interior[name][lo:L - hi if hi else L])
      if hi:
        band = {name: jnp.concatenate(
            [arr[L - (lo + hi):], recv_hi[name]], axis=0)
            for name, arr in locals_in.items()}
        high = run_local(band, params)
        for name in output_names:
          pieces[name].append(high[name][lo:lo + hi])
      return {name: jnp.concatenate(pieces[name], axis=0)
              for name in output_names}

    def step(*local_arrays):
      locals_in = dict(zip(input_names, local_arrays[:len(input_names)]))
      params = dict(zip(param_names, local_arrays[len(input_names):]))
      if overlap == 'on':
        outs = step_overlapped(locals_in, params)
        crops = (slice(None),) * dim
      else:
        arrays = {}
        for name, arr in locals_in.items():
          for axis_idx in range(len(axes)):
            arr = exchange(arr, axis_idx)
          arrays[name] = arr
        outs = run_local(arrays, params)
        crops = tuple(
            slice(halos[a][0], halos[a][0] + local[a]) if a < len(axes)
            else slice(None) for a in range(dim))
      results = []
      for k, name in enumerate(output_names):
        out = outs[name][crops]
        if stencil_ref.preserve_border:
          # border: preserve — cells outside the global valid region
          # carry the paired input (reference untiling keeps borders,
          # host.py:846-950); a shard alone cannot tell its seams
          # from the global boundary, so the mask comes from its mesh
          # position
          paired = k if len(input_names) == n_outputs else 0
          base = semantics.wrap(jnp, locals_in[input_names[paired]],
                                stencil_ref.symbol_table[name])
          out = jnp.where(valid_mask(name), out, base)
        results.append(out)
      return tuple(results)

    shard_spec = P(*axes)
    in_specs = tuple([shard_spec] * len(input_names) +
                     [P()] * len(param_names))
    out_specs = tuple([shard_spec] * len(output_names))
    sharded = jax.shard_map(step, mesh=mesh, in_specs=in_specs,
                            out_specs=out_specs)
    self._fn = jax.jit(sharded)
    self._jnp = jnp

  @property
  def fn(self):
    return self._fn

  def prepare(self, inputs: Mapping, params: Optional[Mapping] = None):
    """Wrap, pad to shard multiples, and device-put (positional)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    jnp = self._jnp
    stencil = self.stencil
    axes = self._axes
    pads = tuple(
        (0, p - r) for p, r in zip(self.padded_shape, self.shape))
    needs_pad = self.padded_shape != self.shape
    args = []
    for name in stencil.input_names:
      if name not in inputs:
        raise utils.InputError('missing input: %s' % name)
      arr = jnp.asarray(inputs[name])
      if arr.shape != self.shape:
        raise utils.InputError('input %s shape %s != global shape %s' %
                               (name, arr.shape, self.shape))
      if needs_pad:
        arr = jnp.pad(arr, pads)
      arr = semantics.wrap(jnp, arr, stencil.symbol_table[name])
      args.append(
          jax.device_put(arr, NamedSharding(self.mesh, P(*axes))))
    params = dict(params or {})
    for name in stencil.param_names:
      if name not in params:
        raise utils.InputError('missing param: %s' % name)
      args.append(
          jax.device_put(jnp.asarray(params[name]),
                         NamedSharding(self.mesh, P())))
    return tuple(args)

  def __call__(self, inputs: Mapping, params: Optional[Mapping] = None
               ) -> Dict[str, np.ndarray]:
    outs = self._fn(*self.prepare(inputs, params))
    if self.padded_shape != self.shape:
      crop = tuple(slice(0, r) for r in self.shape)
      outs = tuple(o[crop] for o in outs)
    return dict(zip(self.stencil.output_names, outs))
