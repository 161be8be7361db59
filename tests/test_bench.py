"""bench.py and chip_smoke.py without a GPU, and their phases at tiny
sizes on the CPU.

Timings taken here are of the CPU backend and are never reported as
device numbers: these tests check control flow, shapes and the oracle
comparisons, and that the device paths refuse to run without a GPU.
"""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

import bench
import chip_smoke
from soda_tpu import corpus

REPO = pathlib.Path(__file__).resolve().parent.parent
H100 = 'NVIDIA H100 80GB HBM3'


def _run(args, platform):
  # CUDA_VISIBLE_DEVICES='' hides any card, so "no GPU" holds anywhere
  env = dict(os.environ, JAX_PLATFORMS=platform, PYTHONPATH=str(REPO),
             CUDA_VISIBLE_DEVICES='')
  return subprocess.run([sys.executable] + args, cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize('script', [
    ['chip_smoke.py'], ['chip_smoke.py', '--four'], ['bench.py']])
def test_device_scripts_fail_without_gpu(script):
  """On the CPU the scripts exit non-zero and print no result line."""
  r = _run(script, 'cpu')
  assert r.returncode != 0
  assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
  assert 'GPU' in r.stderr


@pytest.mark.parametrize('args', [
    ['-c', 'import __graft_entry__ as g; g.entry()'],
    ['-m', 'soda_tpu', 'chiprun_out/none.soda', '--run'],
], ids=['entry', 'sodac-run'])
def test_entry_points_do_not_fall_back_to_cpu(args, tmp_path):
  """Asked for a GPU that is not there, the entry points fail instead
  of switching to the CPU."""
  if args[0] == '-m':
    src = tmp_path / 'blur.soda'
    src.write_text(corpus.CORPUS['blur'])
    args = args[:2] + [str(src)] + args[3:] + ['--shape', '16,32']
  r = _run(args, 'cuda')
  assert r.returncode != 0
  assert 'PASS' not in r.stdout


def test_smoke_exits_without_repo(tmp_path):
  """Alone in a directory (no soda_tpu package beside it) the script
  fails before printing anything."""
  lone = tmp_path / 'chip_smoke.py'
  lone.write_text((REPO / 'chip_smoke.py').read_text())
  env = {'PATH': os.environ.get('PATH', ''), 'JAX_PLATFORMS': 'cpu'}
  r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                     capture_output=True, text=True, timeout=300)
  assert r.returncode != 0
  assert r.stdout == ''


def test_bench_row_at_tiny_size():
  row = bench.kernel_row('jacobi2d', (64, 64), H100, reps=2)
  assert row['shape'] == [64, 64]
  assert row['bound'] == 'memory'
  assert row['ms'] > 0 and row['roofline_share'] > 0


def test_device_dims_exceed_l2():
  """Every device grid moves >= 4x the H100's 50 MB L2 per pass."""
  from soda_tpu.profiling import stream_bytes
  for name, shape in corpus.DEVICE_DIMS.items():
    stencil = corpus.build_for_grid(name, shape)
    assert sum(stream_bytes(stencil, shape)) >= 4 * 50e6, name


@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_smoke_corpus_phase_at_tiny_size(name):
  shape = (12, 24, 40) if name.endswith('3d') else (48, 72)
  rec = chip_smoke.run_kernel(name, shape, H100, reps=1)
  assert rec['criterion_error'] <= max(rec['threshold'], 0)
  assert rec['byte_roofline_share'] > 0
  assert rec['memory_analysis']['argument_size_in_bytes'] > 0


def test_smoke_max_error_rejects_a_wrong_cell():
  from soda_tpu.backend import reference
  stencil = corpus.build('blur')
  shape = (40, 64)
  want = reference.run(stencil, reference.make_test_inputs(stencil, shape))
  got = {'blur_y': want['blur_y'].copy()}
  got['blur_y'][10, 10] += 1
  with pytest.raises(chip_smoke.PhaseError, match='1 of'):
    chip_smoke.max_error(stencil, shape, got, want)


def test_smoke_cli_and_chained_phases(tmp_path):
  dims = {'blur': (40, 64), 'jacobi3d': (12, 24, 40)}
  chip_smoke.phase_cli(dims, tmp_path)
  assert (tmp_path / 'blur.soda').exists()
  assert chip_smoke.phase_chained((48, 40)) <= chip_smoke.ADJOINT_RTOL


def test_smoke_four_device_phase_on_virtual_devices():
  chip_smoke.phase_four(
      jax.devices()[:4],
      {'jacobi2d': (64, 48), 'seidel2d': (64, 48), 'jacobi3d': (32, 16, 24)},
      replica_shape=(32, 40))
