"""sodac-tpu: the command-line driver.

Rebuild of the reference CLI (/root/reference/src/soda/sodac.py): parse
a .soda program (file or stdin), apply directive overrides, construct
the Stencil, and dispatch backend actions. The FPGA codegen targets are
replaced by JAX ones:

  --emit-jax FILE     print a standalone JAX program  (was: HLS C++)
  --emit-dot FILE     graphviz of the fusion plan     (dataflow.py:36)
  --estimate FILE     analytic roofline estimate      (model/xilinx.py)
  --run               execute + self-test vs the NumPy oracle, print
                      throughput (was: generated host's SODA_TEST_MAIN)
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Optional

from soda_tpu import utils


def _build_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(
      prog='sodac-tpu',
      description='SODA stencil compiler (JAX/XLA backends)')
  parser.add_argument('--verbose', '-v', action='count', default=0,
                      help='increase verbosity')
  parser.add_argument('--quiet', '-q', action='count', default=0,
                      help='decrease verbosity')
  parser.add_argument('--recursion-limit', type=int, default=3000,
                      help='Python recursion limit')
  parser.add_argument('soda_src', metavar='FILE',
                      help='SODA program, or - for stdin')

  override = parser.add_argument_group('directive overrides',
                                       'override in-file DSL directives '
                                       '(reference sodac.py:45-93)')
  override.add_argument('--burst-width', type=int)
  override.add_argument('--unroll-factor', type=int)
  override.add_argument('--replication-factor', type=int)
  override.add_argument('--tile-size', type=str,
                        help='comma-separated, e.g. 2048 or 128,128')
  override.add_argument('--dram-in', type=str)
  override.add_argument('--dram-out', type=str)
  override.add_argument('--iterate', type=int)
  override.add_argument('--border', choices=('ignore', 'preserve'))
  override.add_argument('--cluster',
                        choices=('none', 'fine', 'coarse', 'full'))

  opt = parser.add_argument_group('optimizations')
  opt.add_argument('--computation-reuse',
                   choices=('no', 'yes', 'greedy', 'optimal', 'beam',
                            'glore', 'external', 'built-in',
                            'built-in:greedy', 'built-in:optimal'),
                   default='no')
  opt.add_argument('--inline', action='store_true')
  opt.add_argument('--distribute', action='store_true',
                   help='factor shared coefficients: a*c + b*c -> (a+b)*c')
  opt.add_argument('--no-separable', action='store_true',
                   help='disable rank-1 separable factorization of '
                        'linear stages (on by default)')

  backend = parser.add_argument_group('backends')
  backend.add_argument('--emit-jax', metavar='FILE',
                       help='generate a standalone JAX program (- = stdout)')
  backend.add_argument('--emit-numpy', metavar='FILE',
                       help='generate a pure-NumPy reference program')
  backend.add_argument('--emit-dot', metavar='FILE',
                       help='dump the fusion-plan DAG as graphviz')
  backend.add_argument('--estimate', metavar='FILE',
                       help='write the analytic roofline estimate JSON for '
                            'the attached device')
  backend.add_argument('--model-file', metavar='FILE',
                       help='JSON replacing the device peaks for '
                            '--estimate ({"name": .., "hbm_gbps": .., '
                            '"gflops": ..}; the analog of the '
                            'reference --model-file, model/xilinx.py)')
  backend.add_argument('--compile-stats', metavar='FILE',
                       help='compile the executor and dump XLA cost/'
                            'memory analysis (the csynth-report analog)')
  backend.add_argument('--run', action='store_true',
                       help='execute and self-test against the oracle')
  backend.add_argument('--bench', action='store_true',
                       help='with --run: time the kernel, print pixel/ns')
  backend.add_argument('--backend',
                       choices=('auto', 'xla', 'sharded', 'replicated'),
                       default='auto')
  backend.add_argument('--shape', type=str,
                       help='grid shape, comma-separated, streaming axis '
                            'first (default: derived from tile size)')
  backend.add_argument('--seed', type=int, default=0)
  backend.add_argument('--mesh', type=str,
                       help='device mesh shape for --backend sharded, '
                            'e.g. 8 or 4,2 (default: all devices x 1)')
  return parser


def _parse_ints(text: str):
  try:
    return tuple(int(x) for x in text.split(','))
  except ValueError:
    raise utils.InputError(
        'expected comma-separated integers (e.g. 1000,1000), got %r'
        % text) from None


def _default_shape(stencil):
  rest = tuple(reversed(stencil.tile_size[:-1]))
  return (256,) + rest


def main(argv: Optional[list] = None) -> int:
  """CLI entry; user-input errors exit 1 with a one-line message
  (reference sodac exits 1 on SemanticError, soda/sodac.py:146-152)."""
  try:
    return _main(argv)
  except utils.InputError as e:
    print('sodac-tpu: error: %s' % e, file=sys.stderr)
    return 1


def _main(argv: Optional[list] = None) -> int:
  parser = _build_parser()
  args = parser.parse_args(argv)
  sys.setrecursionlimit(args.recursion_limit)
  level = logging.WARNING - 10 * args.verbose + 10 * args.quiet
  logging.basicConfig(
      level=max(logging.DEBUG, min(logging.CRITICAL, level)),
      format='%(levelname)s:%(name)s:%(lineno)d: %(message)s')

  if args.soda_src == '-':
    source = sys.stdin.read()
  else:
    with open(args.soda_src) as f:
      source = f.read()

  overrides = {}
  for key in ('burst_width', 'unroll_factor', 'replication_factor',
              'iterate', 'border', 'cluster', 'dram_in', 'dram_out'):
    value = getattr(args, key)
    if value is not None:
      overrides[key] = value
  if args.tile_size:
    overrides['tile_size'] = _parse_ints(args.tile_size) + (0,)
  optimizations = {}
  if args.computation_reuse != 'no':
    optimizations['computation-reuse'] = args.computation_reuse
  if args.inline:
    optimizations['inline'] = True
  if args.distribute:
    optimizations['distribute'] = True
  if args.no_separable:
    optimizations['separable'] = 'no'
  if optimizations:
    overrides['optimizations'] = optimizations

  from soda_tpu import api
  try:
    stencil = api.build_stencil(source, **overrides)
  except utils.SemanticError as e:
    parser.error('invalid SODA program: %s' % e)
    return 1

  did_something = False
  for emit_arg, target in ((args.emit_jax, 'jax'),
                           (args.emit_numpy, 'numpy')):
    if not emit_arg:
      continue
    from soda_tpu.codegen import jax_source
    shape = _parse_ints(args.shape) if args.shape else None
    if emit_arg == '-':
      jax_source.print_code(stencil, sys.stdout, shape, target)
    else:
      with open(emit_arg, 'w') as f:
        jax_source.print_code(stencil, f, shape, target)
    did_something = True

  if args.emit_dot:
    from soda_tpu.backend.plan import make_plan
    plan = make_plan(stencil)
    text = plan.dot()
    if args.emit_dot == '-':
      sys.stdout.write(text + '\n')
    else:
      with open(args.emit_dot, 'w') as f:
        f.write(text + '\n')
    did_something = True

  if args.estimate:
    from soda_tpu.model import estimate as model
    shape = _parse_ints(args.shape) if args.shape else \
        _default_shape(stencil)
    device = model_params = None
    if args.model_file:
      import json as json_mod
      with open(args.model_file) as f:
        model_params = json_mod.load(f)
    else:
      import jax
      device = jax.devices()[0]
    if args.estimate == '-':
      model.print_estimation(stencil, shape, sys.stdout, device,
                             model_params)
    else:
      with open(args.estimate, 'w') as f:
        model.print_estimation(stencil, shape, f, device, model_params)
    did_something = True

  if args.compile_stats:
    import json as json_mod
    from soda_tpu.backend import get_executor, reference
    from soda_tpu.model.compiled import compiled_stats
    shape = _parse_ints(args.shape) if args.shape else \
        _default_shape(stencil)
    executor = get_executor(stencil, shape)
    inputs = reference.make_test_inputs(stencil, shape)
    params = reference.make_test_params(stencil)
    stats = compiled_stats(executor, inputs, params)
    text = json_mod.dumps(stats, indent=2, default=str) + '\n'
    if args.compile_stats == '-':
      sys.stdout.write(text)
    else:
      with open(args.compile_stats, 'w') as f:
        f.write(text)
    did_something = True

  if args.run:
    did_something = True
    # persistent XLA compilation cache: repeat runs of the same
    # stencil/shape skip the first compile (the analog of the
    # reference's stencil-text-keyed floorplan cache, cluster.py:104-160)
    from soda_tpu import cache as _cache
    try:
      _cache.enable()
    except OSError as e:  # an unwritable cache directory only costs time
      logging.getLogger().warning('compilation cache disabled: %r', e)
    code = _run(stencil, args)
    if code:
      return code

  if not did_something:
    parser.error('no action requested '
                 '(--emit-jax/--emit-dot/--estimate/--run)')
  return 0


def _run(stencil, args) -> int:
  """Execute on random inputs and verify against the NumPy oracle —
  the analog of running the generated host with SODA_TEST_MAIN."""
  import numpy as np
  from soda_tpu.backend import reference

  shape = _parse_ints(args.shape) if args.shape else _default_shape(stencil)
  inputs = reference.make_test_inputs(stencil, shape, seed=args.seed)
  params = reference.make_test_params(stencil)
  want = reference.run(stencil, inputs, params)

  backend = args.backend
  if backend == 'replicated':
    # R independent grids batch through one vmapped launch; the
    # self-test runs the SAME grid in every batch slot and checks
    # slot 0 against the oracle (reference replication semantics:
    # identical pipelines over independent tiles, core.py:565-614)
    from soda_tpu.backend import get_executor
    inner = get_executor(stencil, shape, backend)
    r = inner.replication_factor

    class _Batched:
      replication_factor = r

      def __call__(self, ins, pars=None):
        batched = {k: np.stack([v] * r) for k, v in ins.items()}
        outs = inner(batched, pars)
        return {k: np.asarray(v)[0] for k, v in outs.items()}

    executor = _Batched()
  elif backend in ('auto', 'xla'):
    from soda_tpu.backend import get_executor
    executor = get_executor(stencil, shape, backend)
  else:  # sharded
    from soda_tpu.parallel.spmd import ShardedExecutor
    mesh = None
    if args.mesh:
      import jax
      from jax.sharding import Mesh
      dims = _parse_ints(args.mesh)
      n = 1
      for d in dims:
        n *= d
      devices = np.array(jax.devices()[:n]).reshape(dims)
      mesh = Mesh(devices, tuple('xy'[:len(dims)]))
    executor = ShardedExecutor(stencil, shape, mesh=mesh)

  t0 = time.perf_counter()
  outs = executor(inputs, params)
  compile_and_run_s = time.perf_counter() - t0

  import os
  # THRESHOLD env override, same knob as the generated hosts
  # (reference frt/host.py:633-641, xilinx/host.py:1201-1204)
  # squared-form criterion, reference frt/host.py:633-657 (their
  # ``threshold *= threshold``); default relaxed to 1e-4 for XLA's FMA
  # contraction vs the individually-rounded oracle (tests/checks.py)
  default = utils.threshold_for(stencil.app_name)
  threshold = float(os.environ.get('THRESHOLD', repr(default)))
  errors = 0
  for name in stencil.output_names:
    if stencil.preserve_border:
      # preserve mode defines the WHOLE grid (boundary carries the
      # paired input) — compare it all, like the hardware gate
      got = np.asarray(outs[name])
      expect = np.asarray(want[name])
    else:
      region = reference.output_valid_slices(stencil, shape, name)
      got = np.asarray(outs[name])[region]
      expect = want[name][region]
    if stencil.symbol_table[name].is_float:
      bad = utils.criterion_misses(got, expect, threshold)
    else:
      bad = got != expect
    errors += int(bad.sum())
  cells = int(np.prod(shape))
  print('INFO: %s!' % ('FAIL' if errors else 'PASS'))
  print('Grid: %s (%d cells), backend=%s, compile+run %.3f s' %
        ('x'.join(map(str, shape)), cells, args.backend, compile_and_run_s))

  if args.bench:
    from soda_tpu.profiling import stream_bytes, time_per_call
    grids = 1
    if backend == 'replicated':
      grids = inner.replication_factor
      batched = {k: np.stack([v] * grids) for k, v in inputs.items()}
      fn, fn_args = inner.fn, inner.prepare(batched, params)
    else:
      fn, fn_args = executor.fn, executor.prepare(inputs, params)
    dt = time_per_call(fn, fn_args)
    moved = grids * sum(stream_bytes(stencil, shape))
    # same surface as the generated hosts (reference host.py:816-823)
    print('Kernel execution time: %.3f ms' % (dt * 1e3))
    print('Kernel throughput: %.6f pixel/ns' % (grids * cells / dt / 1e9))
    print('Effective HBM bandwidth: %.1f GB/s' % (moved / dt / 1e9))
  return 1 if errors else 0


if __name__ == '__main__':
  sys.exit(main())
