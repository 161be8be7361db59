"""Smoke test of the stencil compiler's main path on NVIDIA GPUs.

Usage, from the repository root on a machine with the cards:

  python chip_smoke.py          # one GPU: phases 1-4 below
  python chip_smoke.py --four   # four GPUs: phase 1 and the multi-device
                                # path (sharded + replicated) only

Phases, each printing one result line; the first failure ends the run
with a non-zero exit code:

  1. device   JAX's first device must be a GPU. Prints its kind and count
              and the card's name and power limit (nvidia-smi).
  2. corpus   All 11 corpus kernels through ``get_executor`` at
              ``corpus.DEVICE_DIMS`` (2-D 8192x8192, 3-D 1024x256x256:
              every pass moves >= 4x the 50 MB L2), compared with the
              NumPy oracle on the valid region: integers bit-exact,
              floats by the squared-form ``utils.threshold_for``
              criterion. Prints the maximum error, compile time
              (set-up), time per application (``profiling.REPS`` calls
              issued back to back after a warm-up, the clock stopped
              when the last result is ready), its share of the byte
              roofline, and ``compiled.memory_analysis()``. Fails if any
              compiled module calls cuBLAS or cuDNN.
  3. cli      ``sodac --run --bench`` in-process for blur and jacobi3d
              from a .soda file written to chiprun_out/chip_smoke/.
  4. chained  ``soda_tpu.chained`` over jacobi2d against the same number
              of oracle passes, and the adjoint identity
              <J v, w> = <v, J^T w> through ``jax.vjp``.

The last line of standard output is one JSON object naming the device.
Per-kernel numbers also go to chiprun_out/chip_smoke/result.json.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parent
if str(REPO_ROOT) not in sys.path:
  sys.path.insert(0, str(REPO_ROOT))

import numpy as np  # noqa: E402

from soda_tpu import cache, corpus, profiling, utils  # noqa: E402

OUT_DIR = REPO_ROOT / 'chiprun_out' / 'chip_smoke'
SEED = 0
# relative tolerance of the adjoint identity: both sides are f32
# stencil sweeps summed in float64, so they agree to ~1e-7 relative
ADJOINT_RTOL = 1e-4
# per-shard grids of --four hold 1 GiB per f32 array (4x 268M cells
# over 4 cards: 256 MiB per shard, > 4x the L2)
FOUR_DIMS = {'jacobi2d': (16384, 16384), 'seidel2d': (16384, 16384),
             'jacobi3d': (1024, 512, 512)}
# library calls that would mean a dot or convolution (and TF32) crept
# into the elementwise stencil path
_LIBRARY_CALL = re.compile(r'cublas|cudnn', re.IGNORECASE)


class PhaseError(Exception):
  """A phase's check failed."""


def log(line: str) -> None:
  print(line, flush=True)


def max_error(stencil, shape, got, want):
  """(largest |got - want|, largest criterion error) over every
  output's compared region; raises PhaseError when an output misses
  the repo's pass criterion. The criterion error of a float cell is
  min(|d|, |d / want|), which the squared-form check holds to
  ``utils.threshold_for``; integers must be exact."""
  from soda_tpu.backend import reference
  worst = crit = 0.0
  for name in stencil.output_names:
    region = (tuple(slice(None) for _ in shape) if stencil.preserve_border
              else reference.output_valid_slices(stencil, shape, name))
    g = np.asarray(got[name])[region]
    w = np.asarray(want[name])[region]
    if stencil.symbol_table[name].is_float:
      bad = int(np.count_nonzero(utils.criterion_misses(
          g, w, utils.threshold_for(stencil.app_name))))
      d = np.abs(g.astype(np.float64) - w.astype(np.float64))
      err = float(d.max())
      with np.errstate(divide='ignore', invalid='ignore'):
        rel = np.where(d > 0, d / np.abs(w.astype(np.float64)), 0.0)
      crit = max(crit, float(np.minimum(d, rel).max()))
    else:
      diff = np.abs(g.astype(np.int64) - w.astype(np.int64))
      bad = int(np.count_nonzero(diff))
      err = float(diff.max())
      crit = max(crit, err)
    if bad:
      raise PhaseError('%s:%s: %d of %d cells differ from the oracle '
                       '(max error %g)' % (stencil.app_name, name, bad,
                                           g.size, err))
    worst = max(worst, err)
  return worst, crit


def phase_device(expect_count: int = 1):
  """Phase 1: the device must be a GPU; returns the jax device list."""
  import jax
  devices = jax.devices()
  if devices[0].platform != 'gpu':
    raise PhaseError('JAX found no GPU (platform %r)' %
                     devices[0].platform)
  if len(devices) < expect_count:
    raise PhaseError('need %d GPUs, JAX found %d' %
                     (expect_count, len(devices)))
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout
  log('device: kind=%r count=%d' % (devices[0].device_kind, len(devices)))
  for line in smi.strip().splitlines():
    log('nvidia-smi: %s' % line.strip())
  return devices


def run_kernel(name, shape, device=None, reps: int = profiling.REPS):
  """Compile, time and check one corpus kernel; returns its record."""
  from soda_tpu.backend import get_executor, reference
  stencil = corpus.build_for_grid(name, shape)
  inputs = reference.make_test_inputs(stencil, shape, seed=SEED)
  params = reference.make_test_params(stencil)
  executor = get_executor(stencil, shape)
  args = executor.prepare(inputs, params)
  compiled, compile_s, dt = profiling.compile_and_time(
      executor.fn, args, reps)
  library_calls = sorted(set(_LIBRARY_CALL.findall(compiled.as_text())))
  if library_calls:
    raise PhaseError('%s: compiled module calls %s' %
                     (name, ', '.join(library_calls)))
  got = dict(zip(stencil.output_names, compiled(*args)))
  err, crit = max_error(stencil, shape, got,
                        reference.run(stencil, inputs, params))
  mem = compiled.memory_analysis()
  record = {
      'shape': list(shape), 'max_error': err, 'criterion_error': crit,
      'threshold': (utils.threshold_for(name)
                    if any(stencil.symbol_table[o].is_float
                           for o in stencil.output_names) else 0),
      'compile_s': compile_s,
      'ms': dt * 1e3, 'bytes': sum(profiling.stream_bytes(stencil, shape)),
      'memory_analysis': {
          key: getattr(mem, key, None) for key in (
              'argument_size_in_bytes', 'output_size_in_bytes',
              'temp_size_in_bytes', 'generated_code_size_in_bytes')},
  }
  if device is not None:
    peak = profiling.peak(device)
    record['byte_roofline_share'] = (
        record['bytes'] / peak.hbm_bytes_per_s / dt)
  return record


def phase_corpus(dims, device=None, reps: int = profiling.REPS):
  """Phase 2: every corpus kernel at ``dims`` vs the oracle."""
  records = {}
  for name, shape in sorted(dims.items()):
    rec = run_kernel(name, shape, device, reps)
    records[name] = rec
    log('corpus %s %s: max_error=%g criterion_error=%g (threshold %g) '
        'compile_s=%.2f ms=%.4f byte_roofline_share=%s '
        'memory_analysis=%s' % (
            name, 'x'.join(map(str, shape)), rec['max_error'],
            rec['criterion_error'], rec['threshold'],
            rec['compile_s'], rec['ms'],
            '%.4f' % rec['byte_roofline_share']
            if 'byte_roofline_share' in rec else 'n/a',
            json.dumps(rec['memory_analysis'])))
  return records


def phase_cli(dims, out_dir: pathlib.Path):
  """Phase 3: sodac --run --bench in-process for blur and jacobi3d."""
  from soda_tpu import sodac
  out_dir.mkdir(parents=True, exist_ok=True)
  for name in ('blur', 'jacobi3d'):
    shape = dims[name]
    path = out_dir / ('%s.soda' % name)
    path.write_text(corpus.CORPUS[name])
    argv = [str(path), '--run', '--bench',
            '--shape', ','.join(map(str, shape)),
            '--tile-size', ','.join(map(str, reversed(shape[1:])))]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
      code = sodac.main(argv)
    text = buf.getvalue()
    if code != 0 or 'INFO: PASS' not in text:
      raise PhaseError('sodac %s exited %d:\n%s' % (name, code, text))
    log('cli %s: %s' % (name, ' | '.join(text.strip().splitlines())))


def phase_chained(shape, n_steps: int = 3):
  """Phase 4: chained jacobi2d vs n oracle passes, then the adjoint
  identity through jax.vjp of the chained map (linear, so exact up to
  rounding). Returns the adjoint's relative difference."""
  import jax
  import soda_tpu
  from soda_tpu.backend import get_executor, reference
  stencil = corpus.build_for_grid('jacobi2d', shape)
  executor = get_executor(stencil, shape)
  fn = soda_tpu.chained(executor, n_steps)
  inputs = reference.make_test_inputs(stencil, shape, seed=SEED)
  (got,) = fn(*executor.prepare(inputs))
  want = inputs['t1']
  for _ in range(n_steps):
    want = reference.run(stencil, {'t1': want})['t0']
  # every application eats one overall halo (2 cells) of valid border
  m = n_steps * 2
  region = (slice(m, shape[0] - m), slice(m, shape[1] - m))
  bad = np.count_nonzero(utils.criterion_misses(
      np.asarray(got)[region], want[region], utils.threshold_for('jacobi2d')))
  if bad:
    raise PhaseError('chained jacobi2d: %d cells miss the oracle' % bad)

  rng = np.random.default_rng(SEED)
  v = rng.standard_normal(shape, dtype=np.float32)
  w = rng.standard_normal(shape, dtype=np.float32)
  jv, pullback = jax.vjp(lambda x: fn(x)[0], jax.device_put(v))
  (jtw,) = pullback(jax.device_put(w))
  lhs = float(np.vdot(np.asarray(jv, np.float64), w.astype(np.float64)))
  rhs = float(np.vdot(v.astype(np.float64), np.asarray(jtw, np.float64)))
  rel = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
  if not rel <= ADJOINT_RTOL:
    raise PhaseError('adjoint: <Jv,w>=%r <v,JTw>=%r rel=%g > %g' %
                     (lhs, rhs, rel, ADJOINT_RTOL))
  log('chained jacobi2d x%d %s: matches %d oracle passes; adjoint '
      '<Jv,w>=%.9g <v,JTw>=%.9g rel=%.3g (tolerance %g)' % (
          n_steps, 'x'.join(map(str, shape)), n_steps, lhs, rhs, rel,
          ADJOINT_RTOL))
  return rel


def phase_four(devices, dims=None, replica_shape=(8192, 8192)):
  """Multi-device path on the first four devices: ShardedExecutor on a
  1-D mesh of 4 and a 2x2 mesh (plus overlap on the 1-D mesh), border:
  preserve on an extent 4 does not divide, and ReplicatedExecutor over
  a mesh of 4 — each against the oracle, each output spanning all
  four devices."""
  from jax.sharding import Mesh
  from soda_tpu.backend import reference
  from soda_tpu.parallel.replicate import ReplicatedExecutor
  from soda_tpu.parallel.spmd import ShardedExecutor
  dims = dims or FOUR_DIMS
  devs = np.array(devices[:4])
  meshes = {'1d': Mesh(devs, ('x',)),
            '2x2': Mesh(devs.reshape(2, 2), ('x', 'y'))}

  def check(tag, stencil, shape, executor, inputs, want):
    t0 = time.perf_counter()
    outs = executor(inputs)
    for out in outs.values():
      out.block_until_ready()
    run_s = time.perf_counter() - t0
    spans = {len(out.sharding.device_set) for out in outs.values()}
    if spans != {4}:
      raise PhaseError('%s: outputs span %s devices, not 4' % (tag, spans))
    err, _ = max_error(stencil, shape, outs, want)
    log('four %s %s: max_error=%g compile+run_s=%.2f device_set=%s' % (
        tag, 'x'.join(map(str, shape)), err, run_s,
        sorted(d.id for d in next(iter(outs.values())).sharding.device_set)))

  for name, shape in sorted(dims.items()):
    stencil = corpus.build_for_grid(name, shape)
    inputs = reference.make_test_inputs(stencil, shape, seed=SEED)
    want = reference.run(stencil, inputs)
    for mesh_tag, mesh in meshes.items():
      check('%s sharded %s' % (name, mesh_tag), stencil, shape,
            ShardedExecutor(stencil, shape, mesh=mesh), inputs, want)
    check('%s sharded 1d overlap' % name, stencil, shape,
          ShardedExecutor(stencil, shape, mesh=meshes['1d'], overlap='on'),
          inputs, want)
    del inputs, want

  rows, cols = dims['jacobi2d']
  shape = (rows + 2, cols)  # 4 does not divide the streaming extent
  stencil = corpus.build_for_grid('jacobi2d', shape, border='preserve')
  inputs = reference.make_test_inputs(stencil, shape, seed=SEED)
  check('jacobi2d preserve 1d', stencil, shape,
        ShardedExecutor(stencil, shape, mesh=meshes['1d']), inputs,
        reference.run(stencil, inputs))
  del inputs

  stencil = corpus.build_for_grid('jacobi2d', replica_shape)
  grids = [reference.make_test_inputs(stencil, replica_shape, seed=k)
           for k in range(4)]
  executor = ReplicatedExecutor(stencil, replica_shape,
                                replication_factor=4, mesh=meshes['1d'])
  outs = executor({'t1': np.stack([g['t1'] for g in grids])})
  spans = len(outs['t0'].sharding.device_set)
  if spans != 4:
    raise PhaseError('replicated: output spans %d devices, not 4' % spans)
  err = 0.0
  for k, grid in enumerate(grids):
    err = max(err, max_error(stencil, replica_shape,
                             {'t0': np.asarray(outs['t0'][k])},
                             reference.run(stencil, grid))[0])
  log('four jacobi2d replicated x4 %s: max_error=%g device_set=%s' % (
      'x'.join(map(str, replica_shape)), err,
      sorted(d.id for d in outs['t0'].sharding.device_set)))


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--four', action='store_true',
                      help='run only the four-GPU multi-device path')
  args = parser.parse_args(argv)
  cache.enable()
  import jax
  try:
    devices = phase_device(4 if args.four else 1)
    if args.four:
      phase_four(devices)
    else:
      device = devices[0]
      records = phase_corpus(corpus.DEVICE_DIMS, device)
      phase_cli(corpus.DEVICE_DIMS, OUT_DIR)
      phase_chained(corpus.DEVICE_DIMS['jacobi2d'])
      OUT_DIR.mkdir(parents=True, exist_ok=True)
      (OUT_DIR / 'result.json').write_text(json.dumps(
          {'device_kind': device.device_kind, 'kernels': records},
          indent=1))
  except PhaseError as e:
    print('chip_smoke: FAILED: %s' % e, file=sys.stderr)
    return 1
  print(json.dumps({'ok': True, 'device': {
      'platform': jax.devices()[0].platform,
      'kind': jax.devices()[0].device_kind,
      'count': len(jax.devices())}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
