"""Tool / aux-subsystem tests: calc-cost, compiled stats, cache, the
device peak table, and the roofline estimate."""

import json
import subprocess
import sys

import pathlib

import jax
import numpy as np
import pytest

from soda_tpu import corpus, profiling, utils
from soda_tpu.backend import get_executor, reference
from soda_tpu.model import estimate
from soda_tpu.model.compiled import compiled_stats

REPO = str(pathlib.Path(__file__).resolve().parent.parent)
H100 = 'NVIDIA H100 80GB HBM3'


def test_calc_cost_cli():
  schedule = {'distance': 10,
              'left': {'distance': 1, 'left': 1, 'right': 1},
              'right': {'distance': 1, 'left': 1, 'right': 1}}
  r = subprocess.run(
      [sys.executable, '-m', 'soda_tpu.tools.calc_cost'],
      input=json.dumps({'schedule': schedule, 'aattrs': None}),
      capture_output=True, text=True, cwd=REPO,
      env={'PATH': '/usr/bin:/bin', 'JAX_PLATFORMS': 'cpu',
           'PYTHONPATH': REPO, 'HOME': '/root'})
  assert r.returncode == 0, r.stderr
  out = json.loads(r.stdout)
  # (x0 + x1) reused at offsets 0 and 10 -> 2 unique ops
  assert out['num_ops'] == 2
  assert out['total_distance'] >= 10


def test_compiled_stats_reports_memory():
  stencil = corpus.build('blur')
  shape = corpus.TEST_DIMS['blur']
  ex = get_executor(stencil, shape)
  inputs = reference.make_test_inputs(stencil, shape)
  stats = compiled_stats(ex, inputs)
  assert stats['output_size_in_bytes'] == np.prod(shape) * 2  # uint16
  assert stats['argument_size_in_bytes'] == np.prod(shape) * 2


def test_cache_follows_env_var(monkeypatch, tmp_path):
  """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting is used and
  the code sets no other directory."""
  from soda_tpu import cache
  monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / 'from_env'))
  before = jax.config.jax_compilation_cache_dir
  try:
    assert cache.enable() == str(tmp_path / 'from_env')
    assert jax.config.jax_compilation_cache_dir == before
  finally:
    jax.config.update('jax_compilation_cache_dir', before)


def test_cache_defaults_to_fixed_dir_in_checkout(monkeypatch):
  from soda_tpu import cache
  monkeypatch.delenv(cache.ENV_VAR, raising=False)
  before = jax.config.jax_compilation_cache_dir
  try:
    path = cache.enable()
    assert path == str(pathlib.Path(REPO) / '.jax_cache')
    assert jax.config.jax_compilation_cache_dir == path
  finally:
    jax.config.update('jax_compilation_cache_dir', before)
  ignored = (pathlib.Path(REPO) / '.gitignore').read_text().split()
  assert '.jax_cache/' in ignored


def test_peak_table_knows_the_h100():
  p = profiling.peak(H100)
  assert p.hbm_bytes_per_s == 3.35e12
  assert p.flops_per_s == 67e12


def test_peak_of_unknown_device_raises():
  with pytest.raises(utils.InputError, match='no published peak'):
    profiling.peak(jax.devices()[0])  # the CPU test device
  with pytest.raises(utils.InputError):
    profiling.peak('NVIDIA H100 PCIe')


@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_roofline_estimate(name):
  """bytes = every input read once + every output written once; ops =
  the executed stage schedule; the bound is the larger time."""
  stencil = corpus.build(name)
  shape = corpus.DEVICE_DIMS[name]
  est = estimate.estimate(stencil, shape, H100)
  cells = float(np.prod(shape))
  width = sum(stencil.symbol_table[n].width_in_bytes
              for n in stencil.input_names + stencil.output_names)
  assert est['hbm_bytes'] == cells * width
  assert est['flops_per_cell'] == sum(estimate.op_counts(stencil).values())
  memory_s = est['hbm_bytes'] / 3.35e12
  compute_s = est['flops_per_cell'] * cells / 67e12
  assert est['roofline_time_s'] == pytest.approx(max(memory_s, compute_s))
  assert est['bound'] == ('memory' if memory_s >= compute_s else 'compute')
  assert est['stages'] >= 1


def test_estimate_model_file_overrides_table():
  stencil = corpus.build('jacobi2d')
  est = estimate.estimate(stencil, (512, 64), model_params={
      'name': 'toy', 'hbm_gbps': 100.0, 'gflops': 1.0})
  assert est['device'] == 'toy'
  assert est['memory_time_s'] == pytest.approx(512 * 64 * 8 / 100e9)
  assert est['compute_time_s'] == pytest.approx(512 * 64 * 10 / 1e9)
  assert est['bound'] == 'compute'


def test_time_per_call_blocks_until_ready():
  stencil = corpus.build('jacobi2d')
  ex = get_executor(stencil, (64, 64))
  args = ex.prepare(reference.make_test_inputs(stencil, (64, 64)))
  compiled, compile_s, dt = profiling.compile_and_time(ex.fn, args, reps=3)
  assert compile_s > 0 and dt > 0
  (out,) = compiled(*args)
  assert out.shape == (64, 64)
