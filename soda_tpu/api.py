"""Top-level convenience API: text -> Stencil -> executable."""

from __future__ import annotations

from soda_tpu.core.stencil import Stencil
from soda_tpu.frontend import parser


def build_stencil(source: str, **overrides) -> Stencil:
  """Parse SODA DSL text and construct a Stencil.

  ``overrides`` may replace any directive (burst_width, unroll_factor,
  tile_size, iterate, border, cluster, replication_factor, dram_in,
  dram_out, optimizations) — the analog of the reference CLI's
  override flags (sodac.py:45-97).
  """
  program = parser.parse(source)
  args = dict(
    border=program.border,
    burst_width=program.burst_width,
    cluster=program.cluster,
    iterate=program.iterate,
    app_name=program.app_name,
    unroll_factor=program.unroll_factor,
    replication_factor=overrides.pop('replication_factor', 1),
    dim=program.dim,
    tile_size=program.tile_size,
    input_stmts=list(program.input_stmts),
    param_stmts=list(program.param_stmts),
    local_stmts=list(program.local_stmts),
    output_stmts=list(program.output_stmts),
  )
  args.update(overrides)
  return Stencil(**args)


def build_stencil_from_file(path: str, **overrides) -> Stencil:
  with open(path) as f:
    return build_stencil(f.read(), **overrides)


def chained(executor, n_steps: int):
  """One-dispatch multi-step driver: apply the stencil ``n_steps``
  times device-side, feeding outputs back as inputs.

  Works with any executor exposing ``fn`` (XLA, sharded) — under jit,
  a sharded executor's halo exchanges run once per step while arrays
  stay resident and sharded, so a
  long relaxation pays ONE dispatch instead of one per sweep-batch.
  Requires a chainable signature: as many outputs as inputs, with
  matching dtypes (the same precondition as ``iterate > 1``).

  Returns a jitted callable with the executor's positional signature
  ``(*inputs, *params) -> (outputs...)``; prepare arguments with
  ``executor.prepare``.
  """
  import jax
  from jax import lax

  from soda_tpu import utils

  stencil = executor.stencil
  n_in = len(stencil.input_names)
  if len(stencil.output_names) != n_in or \
    tuple(stencil.symbol_table[n].np_dtype
       for n in stencil.input_names) != \
    tuple(stencil.symbol_table[n].np_dtype
       for n in stencil.output_names):
    raise utils.InputError(
      'chained() needs as many outputs as inputs with matching '
      'types (as iterate > 1 requires)')

  def run(*args):
    ins = tuple(args[:n_in])
    pars = tuple(args[n_in:])

    def body(_, state):
      outs = executor.fn(*state, *pars)
      return tuple(outs)

    return lax.fori_loop(0, n_steps, body, ins)

  return jax.jit(run)
