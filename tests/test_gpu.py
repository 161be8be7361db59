"""Tests that need an NVIDIA GPU; they skip with a reason elsewhere.

Run on a machine with the card, from the repository root:

  python -m pytest tests/test_gpu.py -m gpu

conftest.py pins the test process to the CPU, so each test runs its
GPU work in one child process on JAX's default platform; the card is
opened by one process at a time.
"""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module')
def gpu_env():
  """Environment for a child process on JAX's default platform; skips
  the test when that platform is not a GPU."""
  env = {k: v for k, v in os.environ.items()
         if k not in ('JAX_PLATFORMS', 'XLA_FLAGS')}
  env['PYTHONPATH'] = str(REPO)
  probe = subprocess.run(
      [sys.executable, '-c', 'import jax; print(jax.devices()[0].platform)'],
      env=env, capture_output=True, text=True, timeout=300)
  platform = probe.stdout.strip() if probe.returncode == 0 else 'none'
  if platform != 'gpu':
    pytest.skip('needs an NVIDIA GPU; JAX found %s' % platform)
  return env


def _run_on_gpu(env, code):
  return subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                        capture_output=True, text=True, timeout=1200)


@pytest.mark.gpu
def test_corpus_compiles_for_gpu_and_matches_oracle(gpu_env):
  """Every corpus kernel, compiled for the card (no interpret mode),
  against the oracle at 2^22 cells; no cuBLAS/cuDNN call."""
  r = _run_on_gpu(gpu_env, '''
import chip_smoke
from soda_tpu import corpus
for name in sorted(corpus.CORPUS):
  shape = (256, 128, 128) if name.endswith('3d') else (2048, 2048)
  chip_smoke.run_kernel(name, shape, reps=2)
print('OK')
''')
  assert r.returncode == 0 and 'OK' in r.stdout, r.stderr[-4000:]


@pytest.mark.gpu
def test_chained_adjoint_on_gpu(gpu_env):
  r = _run_on_gpu(gpu_env, '''
import chip_smoke
rel = chip_smoke.phase_chained((2048, 2048))
assert rel <= chip_smoke.ADJOINT_RTOL, rel
print('OK')
''')
  assert r.returncode == 0 and 'OK' in r.stdout, r.stderr[-4000:]
