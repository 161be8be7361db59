"""CLI driver tests (the analog of the reference's sodac invocations in
tests/*.sh)."""

import json
import subprocess
import sys

import pathlib

import pytest

from soda_tpu import corpus

REPO = str(pathlib.Path(__file__).resolve().parent.parent)


def run_cli(args, stdin_text=None):
  return subprocess.run(
      [sys.executable, '-m', 'soda_tpu'] + args,
      input=stdin_text, capture_output=True, text=True, cwd=REPO,
      env={'PATH': '/usr/bin:/bin', 'JAX_PLATFORMS': 'cpu',
           'PYTHONPATH': REPO, 'HOME': '/root'})


def test_emit_jax_stdout():
  r = run_cli(['-', '--emit-jax', '-'], corpus.CORPUS['blur'])
  assert r.returncode == 0, r.stderr
  assert 'def compute(' in r.stdout
  assert 'kernel: blur' in r.stdout


def test_emit_dot(tmp_path):
  out = tmp_path / 'plan.dot'
  r = run_cli(['-', '--emit-dot', str(out)], corpus.CORPUS['sobel2d'])
  assert r.returncode == 0, r.stderr
  text = out.read_text()
  assert 'digraph' in text and 'mag_x' in text


def test_estimate(tmp_path):
  model = tmp_path / 'h100.json'
  model.write_text(json.dumps({'name': 'H100', 'hbm_gbps': 3350.0,
                               'gflops': 67000.0}))
  out = tmp_path / 'est.json'
  r = run_cli(['-', '--estimate', str(out), '--shape', '512,64',
               '--model-file', str(model)],
              corpus.CORPUS['jacobi2d'])
  assert r.returncode == 0, r.stderr
  est = json.loads(out.read_text())
  assert est['bound'] in ('memory', 'compute')
  assert est['stages'] == 2  # iterate: 2
  assert est['hbm_bytes'] == 512 * 64 * 8  # f32 in + f32 out
  assert est['roofline_time_s'] == max(est['memory_time_s'],
                                       est['compute_time_s'])


def test_run_self_test_passes():
  r = run_cli(['-', '--run', '--backend', 'xla', '--shape', '32,64'],
              corpus.CORPUS['blur'])
  assert r.returncode == 0, r.stderr + r.stdout
  assert 'PASS' in r.stdout


def test_run_with_cr_override():
  r = run_cli(['-', '--run', '--backend', 'xla', '--shape', '32,64',
               '--computation-reuse', 'greedy'],
              corpus.CORPUS['erosion'].replace('(480, *)', '(64, *)'))
  assert r.returncode == 0, r.stderr + r.stdout
  assert 'PASS' in r.stdout


def test_invalid_program_errors():
  r = run_cli(['-', '--run'], 'kernel: broken\n')
  assert r.returncode != 0


def test_no_action_errors():
  r = run_cli(['-'], corpus.CORPUS['blur'])
  assert r.returncode != 0


def test_estimate_needs_a_known_device():
  """Without --model-file the estimate is for the attached device; the
  CPU has no published peak, which is a clean error, not a default."""
  r = run_cli(['-', '--estimate', '-', '--shape', '64,64'],
              corpus.CORPUS['blur'])
  assert r.returncode == 1
  assert 'no published peak' in r.stderr
  assert 'Traceback' not in r.stderr


def test_compile_stats_on_auto_executor(tmp_path):
  out = tmp_path / 'stats.json'
  r = run_cli(['-', '--compile-stats', str(out), '--shape', '64,64'],
              corpus.CORPUS['blur'])
  assert r.returncode == 0, r.stderr
  stats = json.loads(out.read_text())
  assert stats['argument_size_in_bytes'] == 64 * 64 * 2  # uint16


@pytest.mark.parametrize('backend', ['sharded', 'replicated'])
def test_run_bench_parallel_backends(backend):
  r = run_cli(['-', '--run', '--bench', '--backend', backend,
               '--shape', '64,64'], corpus.CORPUS['blur'])
  assert r.returncode == 0, r.stderr + r.stdout
  assert 'PASS' in r.stdout
  assert 'Kernel execution time' in r.stdout


@pytest.mark.parametrize('flag', [
    ['--backend', 'pallas'], ['--tune'], ['--kernel-opt', 'block_rows=16'],
    ['--cr-cost', 'ops']])
def test_retired_flags_are_rejected(flag):
  r = run_cli(['-', '--run', '--shape', '64,64'] + flag,
              corpus.CORPUS['blur'])
  assert r.returncode == 2  # argparse usage error
  assert 'PASS' not in r.stdout
