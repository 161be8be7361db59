"""Sharded (multi-chip) executor tests on the virtual 8-device CPU mesh.

The analog of validating the reference's multi-DRAM-bank partitioning:
domain decomposition + halo exchange must be semantics-preserving
vs the single-chip oracle.
"""

import jax
import numpy as np
import pytest

from soda_tpu import corpus
from soda_tpu.backend import reference
from soda_tpu.parallel.spmd import ShardedExecutor

from checks import assert_close_reference


def check_sharded(name, shape, mesh=None, overlap='off'):
  stencil = corpus.build(name)
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  want = reference.run(stencil, inputs, params)
  ex = ShardedExecutor(stencil, shape, mesh=mesh, overlap=overlap)
  got = ex(inputs, params)
  for out_name in stencil.output_names:
    region = reference.output_valid_slices(stencil, shape, out_name)
    assert_close_reference(
        np.asarray(got[out_name])[region], want[out_name][region],
        stencil.symbol_table[out_name].is_float, f'{name}:{out_name}')


def test_eight_devices_available():
  assert len(jax.devices()) == 8


@pytest.mark.parametrize('name,shape', [
    ('blur', (80, 64)),
    ('jacobi2d', (64, 32)),
    ('sobel2d', (64, 32)),
    ('erosion', (160, 64)),     # 19-tap halo: 9 rows each way
    ('heat3d', (64, 32, 32)),   # 3-D, iterate=2
])
def test_sharded_matches_oracle(name, shape):
  check_sharded(name, shape)


def _shape_for(name):
  return (32, 32, 32) if name.endswith('3d') else (160, 64)


@pytest.mark.parametrize('mesh_shape', [(4,), (2, 2)],
                         ids=['mesh4', 'mesh2x2'])
@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_corpus_on_four_devices(name, mesh_shape):
  """Every corpus kernel over four devices (the four-card layouts:
  a 1-D mesh of 4 and a 2x2 mesh); outputs span all four."""
  from jax.sharding import Mesh
  devices = np.array(jax.devices()[:4]).reshape(mesh_shape)
  mesh = Mesh(devices, tuple('xy'[:len(mesh_shape)]))
  stencil = corpus.build(name)
  shape = _shape_for(name)
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  want = reference.run(stencil, inputs, params)
  got = ShardedExecutor(stencil, shape, mesh=mesh)(inputs, params)
  for out_name in stencil.output_names:
    assert len(got[out_name].sharding.device_set) == 4
    region = reference.output_valid_slices(stencil, shape, out_name)
    assert_close_reference(
        np.asarray(got[out_name])[region], want[out_name][region],
        stencil.symbol_table[out_name].is_float, f'{name}:{out_name}')


def test_indivisible_extent_pads_and_crops():
  # 81 rows over 8 devices: padded to 88 on device, cropped back
  # (the analog of the reference host's aligned tile sizes)
  check_sharded('jacobi2d', (81, 64))
  check_sharded('blur', (73, 64))


def test_indivisible_2d_mesh():
  check_sharded('jacobi2d', (67, 61), mesh=_mesh_2d(4, 2))


def test_sharded_preserve_border():
  """border: preserve under sharding must use the GLOBAL boundary:
  shard-seam cells are interior and must carry computed values."""
  stencil = corpus.build('jacobi2d', border='preserve')
  shape = (64, 32)
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  got = ShardedExecutor(stencil, shape)(inputs)
  # preserve defines every cell, including the border
  assert_close_reference(np.asarray(got['t0']), want['t0'], True,
                         'preserve')


def test_sharded_preserve_border_2d_mesh_int():
  stencil = corpus.build('blur', border='preserve')
  shape = (72, 64)
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  got = ShardedExecutor(stencil, shape, mesh=_mesh_2d(2, 4))(inputs)
  assert np.array_equal(np.asarray(got['blur_y']), want['blur_y'])


def _mesh_2d(rows, cols):
  import numpy as np
  from jax.sharding import Mesh
  devices = np.array(jax.devices()[:rows * cols]).reshape(rows, cols)
  return Mesh(devices, ('x', 'y'))


@pytest.mark.parametrize('name,shape', [
    ('jacobi2d', (64, 64)),       # iterate=2: halo 2 each way
    ('seidel2d', (64, 64)),       # diagonal taps need corner halos
    ('sobel2d', (64, 64)),
])
def test_2d_mesh_matches_oracle(name, shape):
  check_sharded(name, shape, mesh=_mesh_2d(4, 2))


def test_2d_mesh_3d_grid():
  check_sharded('heat3d', (32, 64, 32), mesh=_mesh_2d(2, 4))


def test_chained_multi_step_driver():
  """soda_tpu.chained: N applications in ONE dispatch, outputs feeding
  inputs, on both single-chip and sharded executors."""
  import soda_tpu
  from soda_tpu.backend import get_executor
  stencil = corpus.build('jacobi2d')  # iterate=2 per application
  shape = (64, 32)
  inputs = reference.make_test_inputs(stencil, shape)

  # oracle: three chained applications
  want = dict(inputs)
  for _ in range(3):
    out = reference.run(stencil, {'t1': want['t1']})
    want = {'t1': out['t0']}

  for ex in (get_executor(stencil, shape),
             ShardedExecutor(stencil, shape)):
    fn = soda_tpu.chained(ex, 3)
    (got,) = fn(*ex.prepare(inputs))
    # after 3 chained runs the garbage border has eaten 3*halo cells
    lo = 3 * 2
    region = (slice(lo, shape[0] - lo), slice(lo, shape[1] - lo))
    np.testing.assert_allclose(np.asarray(got)[region],
                               want['t1'][region], rtol=1e-4, atol=1e-5)


def test_chained_rejects_unchainable():
  import pytest as _pytest
  import soda_tpu
  from soda_tpu import utils
  stencil = corpus.build('sobel2d')  # int16 in, uint16 out
  ex = ShardedExecutor(stencil, (64, 32))
  with _pytest.raises(utils.InputError):
    soda_tpu.chained(ex, 2)


def test_dram_banks_pick_default_mesh_width():
  """DSL `dram` banks map to the default shard count (SURVEY 2.11:
  bank-cyclic partition -> per-device tiles)."""
  from soda_tpu.api import build_stencil
  source = '\n'.join([
      'kernel: banked',
      'burst width: 64',
      'unroll factor: 1',
      'iterate: 1',
      'border: ignore',
      'cluster: none',
      'input dram 0.1.2.3 uint16: x(64, *)',
      'output dram 0.1.2.3 uint16: y(0, 0) = '
      '(x(-1, 0) + x(0, 0) + x(1, 0)) / 3',
  ])
  stencil = build_stencil(source)
  ex = ShardedExecutor(stencil, (64, 64))
  assert ex.mesh.devices.size == 4  # 4 declared banks -> 4 shards
  shape = (64, 64)
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  got = ex(inputs)
  region = reference.output_valid_slices(stencil, shape, 'y')
  assert np.array_equal(np.asarray(got['y'])[region], want['y'][region])
  # single-bank (default) stencils keep using every device
  assert ShardedExecutor(corpus.build('blur'), (80, 64)).mesh.devices.size == 8


@pytest.mark.parametrize('name,shape', [
    ('jacobi2d', (64, 32)),    # iterate=2: two sweeps on one exchange
    ('blur', (80, 64)),        # int multi-stage
    ('sobel2d', (64, 32)),     # mixed int widths
    ('erosion', (320, 64)),    # 19-tap halo: 9 rows each way
])
def test_sharded_overlap_matches_oracle(name, shape):
  """Comm/compute overlap is semantics-preserving."""
  check_sharded(name, shape, overlap='on')


def test_overlap_preserve_border():
  stencil = corpus.build('jacobi2d', border='preserve')
  shape = (64, 32)
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  got = ShardedExecutor(stencil, shape, overlap='on')(inputs)
  assert_close_reference(np.asarray(got['t0']), want['t0'], True,
                         'preserve:overlap')


def test_overlap_validation():
  from soda_tpu import utils
  stencil = corpus.build('jacobi2d')
  with pytest.raises(utils.InputError, match="'off' or 'on'"):
    ShardedExecutor(stencil, (64, 32), overlap='auto')
  with pytest.raises(utils.InputError, match='single-axis'):
    ShardedExecutor(stencil, (64, 32), mesh=_mesh_2d(4, 2), overlap='on')
  # erosion halo is 9+9=18 rows; 80/8 = 10-row shards can't band it
  with pytest.raises(utils.InputError, match='total halo'):
    ShardedExecutor(corpus.build('erosion'), (80, 64), overlap='on')


def _subjaxprs(eqn):
  for v in eqn.params.values():
    for item in (v if isinstance(v, (list, tuple)) else [v]):
      if hasattr(item, 'eqns'):
        yield item
      elif hasattr(item, 'jaxpr') and hasattr(item.jaxpr, 'eqns'):
        yield item.jaxpr


def _find_ppermute_body(jaxpr):
  if any(e.primitive.name == 'ppermute' for e in jaxpr.eqns):
    return jaxpr
  for e in jaxpr.eqns:
    for sub in _subjaxprs(e):
      found = _find_ppermute_body(sub)
      if found is not None:
        return found
  return None


def _untainted_arith(ex, inputs, arith=('add', 'mul', 'sub', 'div')):
  """Count arithmetic eqns in the shard_map body NOT (transitively)
  data-dependent on any ppermute output."""
  args = ex.prepare(inputs)
  body = _find_ppermute_body(jax.make_jaxpr(lambda *a: ex.fn(*a))(
      *args).jaxpr)
  assert body is not None, 'no ppermute in lowered jaxpr'
  tainted = set()
  clean = 0
  for e in body.eqns:
    ins_tainted = any(id(v) in tainted for v in e.invars
                      if not hasattr(v, 'val'))  # skip Literals
    if e.primitive.name == 'ppermute':
      ins_tainted = True
    if ins_tainted:
      tainted.update(id(v) for v in e.outvars)
    elif e.primitive.name in arith:
      clean += 1
  return clean


def test_overlap_interior_independent_of_permutes():
  """The structural claim of the overlap latency model (spmd.py
  docstring): the interior compute chain must be reachable WITHOUT any
  ppermute output, so XLA's latency-hiding scheduler can run it while
  the halo flies. Verified by taint analysis over the shard_map body
  jaxpr. Without overlap every stage op consumes the exchanged
  (concatenated) extension, so all arithmetic is tainted."""
  stencil = corpus.build('jacobi2d')
  shape = (64, 32)
  inputs = reference.make_test_inputs(stencil, shape)
  off = ShardedExecutor(stencil, shape, overlap='off')
  on = ShardedExecutor(stencil, shape, overlap='on')
  assert _untainted_arith(off, inputs) == 0
  # jacobi2d: 4 adds + 1 mul per sweep, 2 sweeps in the interior chain
  assert _untainted_arith(on, inputs) >= 8
  # and the exchange volume is unchanged: one lo + one hi ppermute
  assert _count_collective_permutes(on, inputs) == 2


def _count_collective_permutes(ex, inputs, params=None):
  lowered = ex.fn.lower(*ex.prepare(inputs, params))
  text = lowered.as_text()
  return text.count('collective_permute') + text.count(
      'collective-permute(')


def test_collective_structure_one_exchange_per_input_axis():
  """The spmd latency model (spmd.py docstring) assumes
  exactly ONE halo exchange per input per sharded axis per step — a
  lo-side and a hi-side ppermute — with iterate sweeps and stage
  chains running on the exchanged extension, never re-exchanging.
  Pin that structure by counting collective-permutes in the lowered
  module (the profile-level check available without multi-chip
  hardware)."""
  # jacobi2d: 1 input, iterate=2 (two sweeps), 1-D mesh -> exactly one
  # lo + one hi ppermute; the second sweep must NOT add a pair
  stencil = corpus.build('jacobi2d')
  shape = (64, 32)
  ex = ShardedExecutor(stencil, shape)
  inputs = reference.make_test_inputs(stencil, shape)
  assert _count_collective_permutes(ex, inputs) == 2

  # seidel2d on a 2-D mesh: diagonal taps (corners) are carried by the
  # two-PHASE sequential exchange — still one lo+hi pair per axis (4
  # total), no extra corner collectives
  from jax.sharding import Mesh
  devices = np.array(jax.devices()[:8]).reshape(4, 2)
  mesh2 = Mesh(devices, ('x', 'y'))
  stencil2 = corpus.build('seidel2d')
  ex2 = ShardedExecutor(stencil2, (64, 32), mesh=mesh2)
  inputs2 = reference.make_test_inputs(stencil2, (64, 32))
  assert _count_collective_permutes(ex2, inputs2) == 4

  # sobel2d: multi-stage pipeline, still ONE input -> one pair; the
  # per-stage chain inside run_local must not exchange per stage
  stencil3 = corpus.build('sobel2d')
  ex3 = ShardedExecutor(stencil3, (64, 32))
  inputs3 = reference.make_test_inputs(stencil3, (64, 32))
  assert _count_collective_permutes(ex3, inputs3) == 2
