"""Differential fuzzing: random stencil programs, all executors vs the
NumPy oracle.

Random multi-stage programs over random windows / types / operators
catch semantics edge cases the hand-written corpus misses (type
promotion chains, store offsets, margins). Failures print the full DSL
program for reproduction.
"""

import numpy as np
import pytest

from soda_tpu import utils
from soda_tpu.api import build_stencil
from soda_tpu.backend import reference
from soda_tpu.backend.xla import XlaExecutor
from soda_tpu.parallel.spmd import ShardedExecutor

from checks import assert_close_reference, xla_coarse


def oracle_or_skip(stencil, inputs):
  """Run the oracle; skip the seed when the generated program's
  cumulative window cannot fit the test grid (validate_grid raises a
  clean InputError — a generator artifact, not a bug)."""
  try:
    return reference.run(stencil, inputs)
  except utils.InputError as e:
    pytest.skip('grid too small for generated window: %r' % e)

INT_TYPES = ('int16', 'uint16', 'int32', 'int8')
FLOAT_TYPES = ('float',)


def gen_program(rng: np.random.Generator, dim: int) -> str:
  is_float = bool(rng.integers(0, 2))
  types = FLOAT_TYPES if is_float else INT_TYPES

  def rand_type():
    return types[rng.integers(0, len(types))]

  def rand_idx(span=2):
    return tuple(int(rng.integers(-span, span + 1)) for _ in range(dim))

  def idx_str(idx):
    return ', '.join(map(str, idx))

  in_type = rand_type()
  names = ['src']
  lines = [
      'kernel: fuzz',
      'burst width: 64',
      'unroll factor: 2',
      'iterate: 1',
      'border: ignore',
      'cluster: none',
      'input dram 0 %s: src(%s, *)' % (
          in_type, ', '.join(['32'] * (dim - 1))),
  ]
  if rng.integers(0, 3) == 0:  # second input, same grid
    lines.append('input dram 1 %s: aux' % in_type)
    names.append('aux')
  n_stages = int(rng.integers(1, 4))
  for k in range(n_stages + 1):  # locals + one output
    is_out = k == n_stages
    name = 'out' if is_out else 't%d' % k
    parent = names[rng.integers(0, len(names))]
    n_taps = int(rng.integers(2, 6))
    taps = []
    for _ in range(n_taps):
      ref = '%s(%s)' % (parent, idx_str(rand_idx()))
      if is_float:
        coeff = rng.random() * 2 - 1
        taps.append('%s * %.4ff' % (ref, coeff))
      else:
        coeff = int(rng.integers(-3, 4)) or 1
        taps.append('%s * %d' % (ref, coeff))
    op = ' + ' if rng.integers(0, 2) or is_float else ' + '
    expr = op.join(taps)
    if not is_float and rng.integers(0, 3) == 0:
      expr = 'min(%s, %s(%s))' % (expr, parent, idx_str(rand_idx()))
    dtype = rand_type()
    store = rand_idx(1)
    kind = 'output dram 1' if is_out else 'local'
    lines.append('%s %s: %s(%s) = %s' % (kind, dtype, name,
                                         idx_str(store), expr))
    names.append(name)
  return '\n'.join(lines)


@pytest.mark.parametrize('seed', range(40))
def test_fuzz_backends_match_oracle(seed):
  rng = np.random.default_rng(seed)
  dim = 2 if seed % 3 else 3
  program = gen_program(rng, dim)
  if seed % 5 == 0:
    # exercise iterate>1 (requires one output matching the input type;
    # the generator's single output is named 'out')
    in_type = program.split('input dram 0 ')[1].split(':')[0]
    head, _, tail = program.rpartition('output dram 1 ')
    out_type = tail.split(':')[0].rstrip()
    if out_type == in_type and 'aux' not in program:
      program = program.replace('iterate: 1', 'iterate: 2')
  try:
    stencil = build_stencil(program)
  except Exception as e:  # semantic rejects are fine (e.g. dup names)
    pytest.skip('generator produced invalid program: %r' % e)
  shape = (24, 32) if dim == 2 else (16, 16, 32)
  inputs = reference.make_test_inputs(stencil, shape, seed=seed)
  want = oracle_or_skip(stencil, inputs)
  region = reference.output_valid_slices(stencil, shape)
  if any(s.stop - s.start <= 0 for s in region):
    pytest.skip('window exceeds the test grid')
  is_float = stencil.symbol_table['out'].is_float
  for tag, cls in (('xla', XlaExecutor), ('xla-coarse', xla_coarse)):
    got = cls(stencil, shape)(inputs)
    assert_close_reference(
        np.asarray(got['out'])[region], want['out'][region], is_float,
        '%s seed=%d\n%s' % (tag, seed, program))


@pytest.mark.parametrize('seed', range(40, 55))
def test_fuzz_cr_and_cluster(seed):
  """Fuzz the optimization paths: computation reuse rewrites and the
  per-stage (cluster: coarse) executor must match the oracle of the SAME
  rewritten program (the reference re-runs its corpus per knob;
  random programs cover rewrite edge cases the corpus misses)."""
  rng = np.random.default_rng(seed)
  program = gen_program(rng, 2)
  overrides = {}
  if seed % 2:
    overrides['optimizations'] = {'computation-reuse': 'greedy'}
  try:
    stencil = build_stencil(program, cluster='coarse', **overrides)
  except Exception as e:
    pytest.skip('generator produced invalid program: %r' % e)
  shape = (24, 32)
  inputs = reference.make_test_inputs(stencil, shape, seed=seed)
  want = oracle_or_skip(stencil, inputs)
  region = reference.output_valid_slices(stencil, shape)
  if any(s.stop - s.start <= 0 for s in region):
    pytest.skip('window exceeds the test grid')
  from soda_tpu.backend import get_executor
  got = get_executor(stencil, shape)(inputs)
  assert_close_reference(
      np.asarray(got['out'])[region], want['out'][region],
      stencil.symbol_table['out'].is_float,
      'coarse seed=%d\n%s' % (seed, program))


@pytest.mark.parametrize('seed', range(55, 63))
def test_fuzz_sharded(seed):
  """Fuzz the multi-chip path: random programs over the virtual mesh
  (halo exchange + pad-and-crop) vs the oracle."""
  rng = np.random.default_rng(seed)
  program = gen_program(rng, 2)
  try:
    stencil = build_stencil(program)
  except Exception as e:
    pytest.skip('generator produced invalid program: %r' % e)
  shape = (61, 32) if seed % 2 else (64, 32)  # odd: pad-and-crop
  inputs = reference.make_test_inputs(stencil, shape, seed=seed)
  want = oracle_or_skip(stencil, inputs)
  region = reference.output_valid_slices(stencil, shape)
  if any(s.stop - s.start <= 0 for s in region):
    pytest.skip('window exceeds the test grid')
  try:
    ex = ShardedExecutor(stencil, shape)
  except utils.InputError as e:
    pytest.skip('halo exceeds local extent: %r' % e)
  got = ex(inputs)
  assert_close_reference(
      np.asarray(got['out'])[region], want['out'][region],
      stencil.symbol_table['out'].is_float,
      'sharded seed=%d\n%s' % (seed, program))


def gen_linear_program(rng: np.random.Generator) -> str:
  """Programs aimed at the pass pipeline's newest surface: rank-1
  separable grids (sometimes perturbed off rank 1), overflow-prone sum
  chains (per-stage store wraps), and constant-division tails (pow2 shift vs
  general C division)."""
  is_float = bool(rng.integers(0, 4) == 0)
  in_type = 'float' if is_float else \
      ('int16', 'uint16', 'int32')[rng.integers(0, 3)]

  def coeff():
    return int(rng.integers(-3, 4)) or 1

  d0s = sorted(rng.choice(range(-2, 3), size=int(rng.integers(2, 4)),
                          replace=False))
  d1s = sorted(rng.choice(range(-2, 3), size=int(rng.integers(2, 4)),
                          replace=False))
  u = {i: coeff() for i in d0s}
  v = {j: coeff() for j in d1s}
  taps = ['src(%d, %d) * %d' % (i, j, u[i] * v[j])
          for i in d0s for j in d1s]
  if rng.integers(0, 3) == 0:  # perturb off rank-1
    taps.append('src(%d, %d) * %d' % (int(rng.integers(-2, 3)),
                                      int(rng.integers(-2, 3)), coeff()))
  rng.shuffle(taps)
  t0 = ' + '.join(taps)
  if is_float:
    t0 = '(%s) * 0.25f' % t0

  lines = [
      'kernel: fuzz', 'burst width: 64', 'unroll factor: 1',
      'iterate: 1', 'border: ignore', 'cluster: none',
      'input dram 0 %s: src(64, *)' % in_type,
      'local %s: t0(0, 0) = %s' % (in_type, t0),
  ]
  # consumer chain: sums at shifted offsets (overflow-prone at int16),
  # optionally ending in a constant division
  chain = 't0(0, 0) + t0(1, 0) + t0(0, 1) + t0(1, 1)'
  if not is_float and rng.integers(0, 2):
    div = (2, 4, 8, 256, 3, 7)[rng.integers(0, 6)]
    chain = '(%s) / %d' % (chain, div)
  if rng.integers(0, 3) == 0:
    chain = 'min(%s, t0(-1, 0))' % chain
  lines.append('output dram 1 %s: out(0, 0) = %s' % (in_type, chain))
  return '\n'.join(lines)


@pytest.mark.parametrize('seed', range(63, 95))
def test_fuzz_pass_soundness_vs_unfactored_oracle(seed):
  """The strongest contract check: the FULL pipeline (separable
  factorization + pow2-shift division in the XLA executor) against
  the oracle of the UNFACTORED program. Integer
  programs must be bit-exact end to end; float programs stay within
  the reference THRESHOLD (factorization is reassociation)."""
  rng = np.random.default_rng(seed)
  program = gen_linear_program(rng)
  try:
    factored = build_stencil(program)
    plain = build_stencil(program, optimizations={'separable': 'no'})
  except Exception as e:
    pytest.skip('generator produced invalid program: %r' % e)
  shape = (24, 64)
  inputs = reference.make_test_inputs(plain, shape, seed=seed)
  want = oracle_or_skip(plain, inputs)
  region_p = reference.output_valid_slices(plain, shape)
  region_f = reference.output_valid_slices(factored, shape)
  region = tuple(slice(max(a.start, b.start), min(a.stop, b.stop))
                 for a, b in zip(region_p, region_f))
  if any(s.stop - s.start <= 0 for s in region):
    pytest.skip('window exceeds the test grid')
  is_float = plain.symbol_table['out'].is_float
  got = XlaExecutor(factored, shape)(inputs)
  assert_close_reference(
      np.asarray(got['out'])[region], want['out'][region], is_float,
      'pass-soundness seed=%d\n%s' % (seed, program))


def gen_minmax_window_program(rng: np.random.Generator) -> str:
  """Bare min/max windows over arithmetic tap progressions — the
  idempotent-window CR path's trigger shape (erosion generalized:
  random operator, tap count, stride, axis, store offsets)."""
  in_type = ('int16', 'uint16', 'int32', 'float')[rng.integers(0, 4)]
  lines = [
      'kernel: fuzzmm', 'burst width: 64', 'unroll factor: 1',
      'iterate: 1', 'border: ignore', 'cluster: none',
      'input dram 0 %s: src(48, *)' % in_type,
  ]
  parent = 'src'
  for k in range(int(rng.integers(1, 3)) + 1):
    is_out = k and True
    op = ('min', 'max')[rng.integers(0, 2)]
    n = int(rng.integers(4, 13))
    stride = int(rng.integers(1, 3))
    axis = int(rng.integers(0, 2))
    base = int(rng.integers(-2, 3))
    taps = []
    for i in range(n):
      idx = [0, 0]
      idx[axis] = base + i * stride
      taps.append('%s(%d, %d)' % (parent, idx[0], idx[1]))
    store = (int(rng.integers(0, 3)), int(rng.integers(0, 3)))
    name = 't%d' % k
    lines.append('local %s: %s(%d, %d) = %s(%s)' % (
        in_type, name, store[0], store[1], op, ', '.join(taps)))
    parent = name
  lines.append('output dram 1 %s: out(0, 0) = %s(0, 0)' %
               (in_type, parent))
  return '\n'.join(lines)


@pytest.mark.parametrize('seed', range(105, 125))
def test_fuzz_idempotent_window(seed):
  """The idempotent-window doubling chain vs both the oracle and the
  exact-cover scheduler (knob off): bit-exact three ways. Overlapping
  covers are only sound for idempotent operators, so any operator/
  gating slip shows up as a corrupted tap."""
  rng = np.random.default_rng(seed)
  program = gen_minmax_window_program(rng)
  opts = {'computation-reuse': 'greedy'}
  try:
    chained = build_stencil(program, optimizations=dict(opts))
    exact = build_stencil(program, optimizations=dict(
        opts, **{'idempotent-window': 'no'}))
  except Exception as e:
    pytest.skip('generator produced invalid program: %r' % e)
  shape = (40, 48)
  inputs = reference.make_test_inputs(chained, shape, seed=seed)
  want = oracle_or_skip(exact, inputs)
  region = reference.output_valid_slices(chained, shape)
  region_e = reference.output_valid_slices(exact, shape)
  region = tuple(slice(max(a.start, b.start), min(a.stop, b.stop))
                 for a, b in zip(region, region_e))
  if any(s.stop - s.start <= 0 for s in region):
    pytest.skip('window exceeds the test grid')
  is_float = chained.symbol_table['out'].is_float
  for stencil, tag in ((chained, 'chained'), (exact, 'exact')):
    got = XlaExecutor(stencil, shape)(inputs)
    assert_close_reference(
        np.asarray(got['out'])[region], want['out'][region], is_float,
        'idem-%s seed=%d\n%s' % (tag, seed, program))


@pytest.mark.parametrize('seed', range(95, 105))
def test_fuzz_sharded_2d_mesh(seed):
  """Random 2-D and 3-D programs over a 4x2 mesh of the virtual devices:
  the two-phase exchange must carry corner halos for any window."""
  import jax
  from jax.sharding import Mesh
  rng = np.random.default_rng(seed)
  dim = 2 if seed % 3 else 3
  program = gen_program(rng, dim)
  try:
    stencil = build_stencil(program)
  except Exception as e:
    pytest.skip('generator produced invalid program: %r' % e)
  shape = (64, 64) if dim == 2 else (32, 32, 32)
  inputs = reference.make_test_inputs(stencil, shape, seed=seed)
  want = oracle_or_skip(stencil, inputs)
  region = reference.output_valid_slices(stencil, shape)
  if any(s.stop - s.start <= 0 for s in region):
    pytest.skip('window exceeds the test grid')
  mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ('x', 'y'))
  try:
    ex = ShardedExecutor(stencil, shape, mesh=mesh)
  except utils.InputError as e:
    pytest.skip('halo exceeds local extent: %r' % e)
  got = ex(inputs)
  assert_close_reference(
      np.asarray(got['out'])[region], want['out'][region],
      stencil.symbol_table['out'].is_float,
      'mesh4x2 seed=%d\n%s' % (seed, program))


def gen_multi_output_program(rng: np.random.Generator) -> str:
  """2-D multi-output programs: shared locals feeding two outputs —
  the absolute-CSE / CR emit-dedup surface (a round-2 crash class:
  dedup by cr_var NAME across outputs)."""
  is_float = bool(rng.integers(0, 3) == 0)
  t = 'float' if is_float else INT_TYPES[rng.integers(0, 4)]

  def idx():
    return tuple(int(rng.integers(-2, 3)) for _ in range(2))

  lines = ['kernel: fzmo', 'burst width: 64', 'unroll factor: 1',
           'iterate: 1', 'border: ignore', 'cluster: none',
           'input dram 0 %s: src(32, *)' % t]
  names = ['src']
  for k in range(int(rng.integers(1, 3))):
    parent = names[rng.integers(0, len(names))]
    taps = []
    for _ in range(int(rng.integers(2, 6))):
      c = int(rng.integers(-3, 4)) or 1
      if is_float:
        taps.append('%s(%d, %d) * %.3ff' % ((parent,) + idx() +
                                            (c * 0.25,)))
      else:
        taps.append('%s(%d, %d) * %d' % ((parent,) + idx() + (c,)))
    name = 't%d' % k
    lines.append('local %s: %s(0, 0) = %s' % (t, name, ' + '.join(taps)))
    names.append(name)
  # a third of programs bind a let named `k` in BOTH outputs — with
  # different values half the time (the round-3 review's miscompile
  # class: cross-statement CSE must key on let-CLOSED subtrees)
  with_lets = rng.integers(0, 3) == 0
  let_vals = ((3, 3) if rng.integers(0, 2) else (3, 5)) if with_lets else None
  for o in range(2):
    parent = names[rng.integers(1, len(names))] if len(names) > 1 \
        else 'src'
    a, b = idx(), idx()
    if with_lets and not is_float:
      lines.append('output dram %d %s:\n  %s k = %d\n'
                   '  o%d(0, 0) = k * %s(%d, %d) + k * %s(%d, %d)'
                   % (o, t, t, let_vals[o], o,
                      parent, a[0], a[1], parent, b[0], b[1]))
    else:
      lines.append(
          'output dram %d %s: o%d(0, 0) = %s(%d, %d) + %s(%d, %d)'
          % (o, t, o, parent, a[0], a[1], parent, b[0], b[1]))
  return '\n'.join(lines)


@pytest.mark.parametrize('seed', range(125, 140))
def test_fuzz_multi_output(seed):
  """Multi-output programs through the fused and per-stage XLA
  executors (plus the sharded executor on a subset) vs the oracle,
  every output compared in its own valid region."""
  rng = np.random.default_rng(seed)
  program = gen_multi_output_program(rng)
  if seed % 3 == 0:
    program = program.replace('iterate: 1', 'iterate: 2')
  overrides = {}
  if seed % 2:
    overrides['optimizations'] = {'computation-reuse': 'greedy'}
  try:
    stencil = build_stencil(program, **overrides)
  except Exception:
    try:  # iterate=2 with 2 outputs is a legitimate semantic reject
      program = program.replace('iterate: 2', 'iterate: 1')
      stencil = build_stencil(program, **overrides)
    except Exception as e:
      pytest.skip('generator produced invalid program: %r' % e)
  shape = (41, 48) if seed % 2 else (48, 48)
  inputs = reference.make_test_inputs(stencil, shape, seed=seed)
  want = oracle_or_skip(stencil, inputs)
  outs = stencil.output_names
  regions = {o: reference.output_valid_slices(stencil, shape, name=o)
             for o in outs}
  if any(s.stop - s.start <= 0 for o in outs for s in regions[o]):
    pytest.skip('window exceeds the test grid')
  is_float = stencil.symbol_table[outs[0]].is_float
  runners = [('xla', lambda: XlaExecutor(stencil, shape)),
             ('xla-coarse', lambda: xla_coarse(stencil, shape))]
  if seed % 4 == 2:
    runners.append(('sharded', lambda: ShardedExecutor(stencil, shape)))
  for tag, mk in runners:
    got = mk()(inputs)
    for o in outs:
      assert_close_reference(
          np.asarray(got[o])[regions[o]], want[o][regions[o]], is_float,
          'multi seed=%d cfg=%s out=%s\n%s' % (seed, tag, o, program))
