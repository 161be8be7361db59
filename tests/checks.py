"""Shared comparison helper implementing the reference's pass criterion.

Integer outputs: bit-exact. Float outputs: an element fails only if
the error exceeds THRESHOLD both absolutely and relative to the
reference value — the squared-form check of the generated self-test
(reference frt/host.py:633-657: ``threshold *= threshold`` then
``d*d > threshold && d*d/(cpu*cpu) > threshold``).

The reference defaults THRESHOLD to 1e-5, which assumes both sides
compute with individually-rounded IEEE ops (its HLS float cores match
its C++ host op for op). XLA contracts mul+add into
higher-precision FMAs (measured: plain ``jit(x*50 + y*-51)`` differs
from NumPy by 1 ulp on CPU), so executor-vs-oracle divergence of a few
hundred ulp on cancelling coefficient sums (contrast) is expected —
and accuracy-improving. The suite therefore runs the same criterion at
THRESHOLD=1e-4; kernels without heavy cancellation stay well inside
1e-5.
"""

import numpy as np

from soda_tpu import utils

# The thresholds themselves live in soda_tpu.utils (DEFAULT_THRESHOLD
# 1e-4; KERNEL_THRESHOLDS: contrast 1e-3). contrast's 17x17 table sums
# +-100-coefficient terms to ~5e3 magnitude before cancelling; ONE
# FMA-contracted ulp of the running sum is ~5e-4, so cells that cancel
# toward zero legitimately differ by that much between XLA and the
# individually-rounded oracle. Genuine defects produce O(1)+ errors.
#
# This rationale is MEASURED, not just argued: a float64 oracle computes
# the truth and the executor's error against it is asserted to be no
# worse than the f32 oracle's own error — tests/test_f64_evidence.py.


def xla_coarse(stencil, shape):
  """The XLA executor with one jitted region per stage (cluster:
  coarse): every stage boundary round-trips device memory."""
  from soda_tpu.backend.xla import XlaExecutor
  return XlaExecutor(stencil, shape, cluster='coarse')


def assert_close_reference(got, want, is_float: bool, context: str = '',
                           threshold: float = None):
  got = np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  if not is_float:
    np.testing.assert_array_equal(got, want, err_msg=context)
    return
  if threshold is None:
    # context leads with the kernel's name
    threshold = utils.threshold_for(context)
  bad = utils.criterion_misses(got, want, threshold)
  if bad.any():
    idx = np.argwhere(bad)[0]
    raise AssertionError(
        '%s: %d/%d elements fail reference THRESHOLD=%g; first at %s: '
        'got %r want %r' % (context, int(bad.sum()), bad.size, threshold,
                            tuple(idx), got[tuple(idx)], want[tuple(idx)]))
