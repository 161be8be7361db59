"""Utility tests: serialization round-trip (reference test_util.py) and
toposort behavior."""

import pytest

from soda_tpu import utils


def test_serialize_deserialize_round_trip():
  tile_size = (233, 233, 233, 0)
  idx = (23, 23, 23, 233)
  offset = 23 + 23 * 233 + 23 * 233**2 + 233 * 233**3
  assert utils.serialize(idx, tile_size) == offset
  assert utils.deserialize(offset, tile_size) == idx


def test_serialize_dim0_is_fastest():
  assert utils.serialize((1, 0), (100, 0)) == 1
  assert utils.serialize((0, 1), (100, 0)) == 100


def test_toposort_flatten():
  graph = {'c': {'a', 'b'}, 'b': {'a'}, 'a': set()}
  order = utils.toposort_flatten(graph)
  assert order.index('a') < order.index('b') < order.index('c')


def test_toposort_detects_cycle():
  with pytest.raises(ValueError):
    utils.toposort_flatten({'a': {'b'}, 'b': {'a'}})


def test_toposort_insertion_order():
  graph = {'z': set(), 'y': set(), 'x': {'z'}}
  assert utils.toposort_flatten(graph, sort=False) == ['z', 'y', 'x']


@pytest.mark.parametrize('got, want, miss', [
    (1.00005, 1.0, False),    # inside both bounds
    (1.2e-4, 5e-5, False),    # relative miss, absolute pass
    (2e4 + 1.0, 2e4, False),  # absolute miss, relative pass
    (1.001, 1.0, True),       # outside both bounds
    (-1.0, 1.0, True),
], ids=['close', 'abs-ok', 'rel-ok', 'both-miss', 'sign'])
def test_criterion_misses_needs_both_bounds(got, want, miss):
  """A cell fails only when its error exceeds the threshold both
  absolutely and relative to the oracle value."""
  import numpy as np
  mask = utils.criterion_misses(np.float32([got]), np.float32([want]), 1e-4)
  assert mask.tolist() == [miss]


def test_threshold_for_contrast_prefix():
  assert utils.threshold_for('contrast') == 1e-3
  assert utils.threshold_for('contrast:out') == 1e-3
  assert utils.threshold_for('jacobi2d') == utils.DEFAULT_THRESHOLD
