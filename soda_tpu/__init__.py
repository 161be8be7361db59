"""A stencil dataflow compiler & runtime on JAX.

A ground-up rebuild of the capabilities of Blaok/soda (ICCAD'18 / DAC'20)
that compiles through JAX/XLA (run on NVIDIA GPUs) instead of FPGA HLS.
See SURVEY.md for the reference layer map this framework mirrors.
"""

__version__ = '0.1.0'


def build_stencil(source, **overrides):
  """Parse SODA DSL text into a Stencil (see soda_tpu.api)."""
  from soda_tpu import api
  return api.build_stencil(source, **overrides)


def build_stencil_from_file(path, **overrides):
  from soda_tpu import api
  return api.build_stencil_from_file(path, **overrides)


def get_executor(stencil, shape, backend='auto', **kwargs):
  """Compile a stencil for a grid shape (see soda_tpu.backend)."""
  from soda_tpu.backend import get_executor as _get
  return _get(stencil, shape, backend, **kwargs)


def chained(executor, n_steps):
  """One-dispatch multi-step driver (see soda_tpu.api.chained)."""
  from soda_tpu import api
  return api.chained(executor, n_steps)
