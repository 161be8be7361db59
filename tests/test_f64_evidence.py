"""contrast THRESHOLD evidence: executor error vs the float64 truth.

tests/checks.py loosens contrast's pass threshold to 1e-3 on the
grounds that FMA contraction makes the executor MORE accurate than the
individually-rounded f32 oracle on cancelling coefficient sums. Assert
that, don't argue it: compute the truth once in float64 (the oracle
evaluates `double` in NumPy float64, storage-honest, without jax x64)
and require the executor's error against it to be no worse than the
f32 oracle's own error.
"""

import numpy as np

from soda_tpu import api, corpus
from soda_tpu.backend import reference
from soda_tpu.backend.xla import XlaExecutor


def test_contrast_executor_at_least_as_close_to_f64_truth():
  shape = (512, 512)
  overrides = {'tile_size': (512, 0),
               'optimizations': {'computation-reuse': 'yes'}}
  st32 = corpus.build('contrast', **overrides)
  st64 = api.build_stencil(
      corpus.CORPUS['contrast'].replace(' float:', ' double:'), **overrides)
  inputs = reference.make_test_inputs(st32, shape)
  inputs64 = {k: np.asarray(v, np.float64) for k, v in inputs.items()}
  truth = reference.run(st64, inputs64)['output']
  oracle32 = reference.run(st32, inputs)['output'].astype(np.float64)
  got = np.asarray(XlaExecutor(st32, shape)(inputs)['output'],
                   dtype=np.float64)
  region = reference.output_valid_slices(st32, shape)
  err_exec = float(np.abs(got[region] - truth[region]).max())
  err_orac = float(np.abs(oracle32[region] - truth[region]).max())
  # 1.05x slack: individual cells may round either way; the claim is
  # the executor is not systematically worse than the f32 oracle
  assert err_exec <= err_orac * 1.05 + 1e-9, (err_exec, err_orac)
