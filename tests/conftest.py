"""Test configuration.

Pins JAX to the CPU with 8 virtual devices, so sharding and collective
tests run without accelerators. Tests that need a GPU are marked
``gpu`` and run their device work in a child process (test_gpu.py).
"""

import os

os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '') +
                           ' --xla_force_host_platform_device_count=8')
os.environ['JAX_PLATFORMS'] = 'cpu'

import jax

# also through the config, in case jax was imported before this file
jax.config.update('jax_platforms', 'cpu')

import pathlib
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
  sys.path.insert(0, str(REPO_ROOT))
