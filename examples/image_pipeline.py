"""Example: a two-kernel image pipeline (smooth, then edge-detect).

Shows composing independently-compiled stencils under one jit: XLA
schedules both executors back-to-back on device with no host
round-trips — the analog of chaining SODA bitstreams without
leaving the accelerator.

Run: python examples/image_pipeline.py
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from soda_tpu import build_stencil, get_executor

SMOOTH = '''
kernel: smooth
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 int16: img(1024, *)
local int16: sx(0, 0) = (img(-1, 0) + img(0, 0) * 2 + img(1, 0)) / 4
output dram 1 int16: s(0, 0) = (sx(0, -1) + sx(0, 0) * 2 + sx(0, 1)) / 4
'''

EDGES = '''
kernel: edges
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 int16: s(1024, *)
local int16: gx(0, 0) = (s(1, -1) - s(-1, -1)) + (s(1, 0) - s(-1, 0)) * 2 +
    (s(1, 1) - s(-1, 1))
local int16: gy(0, 0) = (s(-1, 1) - s(-1, -1)) + (s(0, 1) - s(0, -1)) * 2 +
    (s(1, 1) - s(1, -1))
output dram 1 uint16: mag(0, 0) =
  uint16(min(abs(int32(gx(0, 0))) + abs(int32(gy(0, 0))), 65535))
'''


def main():
  shape = (768, 1024)
  smooth = get_executor(build_stencil(SMOOTH), shape)
  edges = get_executor(build_stencil(EDGES), shape)

  @jax.jit
  def pipeline(img):
    (s,) = smooth.fn(img)
    (mag,) = edges.fn(s)
    return mag

  rng = np.random.default_rng(0)
  img = (rng.integers(0, 256, shape) +
         (np.indices(shape).sum(0) // 64 % 2) * 512).astype(np.int16)
  mag = jax.block_until_ready(pipeline(jnp.asarray(img)))
  print('pipeline output:', mag.shape, mag.dtype)
  interior = np.asarray(mag)[4:-4, 4:-4]
  print('edge response mean %.1f max %d' %
        (interior.mean(), interior.max()))
  assert interior.max() > 0


if __name__ == '__main__':
  main()
