"""Compile-time caching.

The reference's only persistent cache is the AutoBridge floorplan cache
keyed by the stencil text (cluster.py:104-160). The analog here is
JAX's persistent compilation cache: identical stencil + shape + flags
hit the cache and skip the first compile.
"""

from __future__ import annotations

import logging
import os
import pathlib

_logger = logging.getLogger().getChild(__name__)

ENV_VAR = 'JAX_COMPILATION_CACHE_DIR'
# A fixed directory inside the checkout (listed in .gitignore): the
# cache key includes the path, so a directory that moved would never hit.
DEFAULT_DIR = pathlib.Path(__file__).resolve().parent.parent / '.jax_cache'


def enable() -> str:
  """Turn on JAX's persistent compilation cache (idempotent).

  JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself when it is set; this
  then sets no other directory. Otherwise the cache lives in
  ``DEFAULT_DIR``. Returns the directory in use.
  """
  import jax
  path = os.environ.get(ENV_VAR)
  if not path:
    path = str(DEFAULT_DIR)
    os.makedirs(path, exist_ok=True)
    jax.config.update('jax_compilation_cache_dir', path)
  jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
  _logger.info('persistent compilation cache at %s', path)
  return path
