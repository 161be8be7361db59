"""Fusion-plan layer tests: margins, halos, grouping, graphviz."""

import pytest

from soda_tpu import corpus
from soda_tpu.backend import plan as plan_mod


def test_blur_margins_and_halo():
  stencil = corpus.build('blur')
  plan = plan_mod.make_plan(stencil)
  by_name = {s.name: s for s in plan.stages}
  # blur_x: input(0, 0..2) -> streaming hi=2 only
  assert by_name['blur_x'].lo == (0, 0)
  assert by_name['blur_x'].hi == (0, 2)
  # blur_y adds dim0 reach
  assert by_name['blur_y'].lo == (0, 0)
  assert by_name['blur_y'].hi == (2, 2)
  assert plan.halo_lo == (0, 0)
  assert plan.halo_hi == (2, 2)


def test_erosion_centered_halo():
  stencil = corpus.build('erosion')
  plan = plan_mod.make_plan(stencil)
  assert plan.halo_lo == (9, 9)
  assert plan.halo_hi == (9, 9)


def test_iterate_accumulates_halo():
  stencil = corpus.build('jacobi2d')  # iterate: 2, 5-point
  plan = plan_mod.make_plan(stencil)
  assert plan.halo_lo == (2, 2)
  assert plan.halo_hi == (2, 2)
  assert len(plan.stages) == 2  # one per sweep


def test_cluster_groups():
  # separable factorization adds the two rank-1 1-D passes, so sobel2d
  # lowers to 5 stages (cr_var_0, cr_var_1, mag_x, mag_y, mag)
  stencil = corpus.build('sobel2d')
  assert len(plan_mod.make_plan(stencil, 'full').groups) == 1
  assert len(plan_mod.make_plan(stencil, 'coarse').groups) == 5
  with pytest.raises(ValueError):
    plan_mod.make_plan(stencil, 'autobridge')


@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_stages_follow_dependencies(name):
  """Every stage reads only inputs, params and stages scheduled before
  it (the order every executor evaluates the plan in)."""
  stencil = corpus.build(name)
  seen = set(stencil.input_names) | set(stencil.param_names)
  for stage in plan_mod.make_plan(stencil).stages:
    assert set(stage.tensor.ld_refs) <= seen, (name, stage.name)
    seen.add(stage.name)
  assert set(stencil.output_names) <= seen


@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_coarse_groups_are_single_stages(name):
  stencil = corpus.build(name)
  full = plan_mod.make_plan(stencil, 'full')
  coarse = plan_mod.make_plan(stencil, 'coarse')
  assert [s.name for s in full.groups[0]] == [s.name for s in full.stages]
  assert [[s.name] for s in coarse.stages] == \
      [[s.name for s in g] for g in coarse.groups]
  assert len(plan_mod.make_plan(stencil, 'fine').groups) == \
      len(coarse.groups)


def test_dot_contains_stages_and_edges():
  stencil = corpus.build('sobel2d')
  dot = plan_mod.make_plan(stencil).dot()
  assert '"img" -> "cr_var_0"' in dot  # separable 1-D pass
  assert '"cr_var_0" -> "mag_x"' in dot
  assert '"mag_y" -> "mag"' in dot


def test_materialized_margins_vs_window_margins():
  """On the hand-written corpus: for OUTPUT tensors the compositional
  margins agree with the reference's overall-window loop bounds; for
  intermediates they are at least as wide (the window bound ignores
  parent validity — the unsoundness materialized_margins fixes)."""
  for name in sorted(corpus.CORPUS):
    stencil = corpus.build(name)
    margins = plan_mod.materialized_margins(stencil)
    for tensor in stencil.chronological_tensors:
      if tensor.is_input():
        continue
      wlo, whi = plan_mod.window_margins(stencil, tensor)
      mlo, mhi = margins[tensor.name]
      if tensor.is_output():
        assert (mlo, mhi) == (wlo, whi), \
            (name, tensor.name, (mlo, mhi), (wlo, whi))
      else:
        assert all(m >= w for m, w in zip(mlo, wlo)), (name, tensor.name)
        assert all(m >= w for m, w in zip(mhi, whi)), (name, tensor.name)


class TestValidateGrid:
  """validate_grid: every executor front door rejects grids smaller
  than the cumulative stencil window with a clean InputError (the
  reference's generated host fixes tile size >= window at compile
  time; here the grid arrives at run time)."""

  def _err(self, fn):
    from soda_tpu import utils
    with pytest.raises(utils.InputError) as ei:
      fn()
    return str(ei.value)

  def test_undersized_named_tensor_and_axis(self):
    # a 2-row grid trips the FIRST offending tensor (blur_x, streaming
    # window 0..2); with enough rows but only 2 lanes, only blur_y's
    # accumulated lane reach (DSL dim 0) trips
    st = corpus.build('blur')
    msg = self._err(lambda: plan_mod.validate_grid(st, (2, 64)))
    assert 'blur_x' in msg and 'dimension 1' in msg
    msg = self._err(lambda: plan_mod.validate_grid(st, (64, 2)))
    assert 'blur_y' in msg and 'dimension 0' in msg

  def test_dim_mismatch(self):
    st = corpus.build('blur')
    msg = self._err(lambda: plan_mod.validate_grid(st, (2, 4, 64)))
    assert '2-D' in msg and '3-D' in msg

  def test_boundary_extent_passes(self):
    # smallest legal grid: window extent + 1 valid cell
    st = corpus.build('blur')  # halo (2, 2) -> 3 rows / 3 lanes min
    plan_mod.validate_grid(st, (3, 128))

  def test_all_executor_front_doors_reject(self):
    from soda_tpu import utils
    from soda_tpu.backend import get_executor, reference
    from soda_tpu.backend.xla import XlaExecutor
    st = corpus.build('erosion')  # 19x19 window
    for mk in (lambda: XlaExecutor(st, (10, 128)),
               lambda: XlaExecutor(st, (10, 128), cluster='coarse'),
               lambda: get_executor(st, (10, 128), 'replicated'),
               lambda: reference.run(
                   st, reference.make_test_inputs(st, (10, 128)))):
      with pytest.raises(utils.InputError):
        mk()
