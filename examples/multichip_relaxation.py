"""Example: multi-chip Jacobi relaxation with one dispatch per batch.

Production pattern for large grids: shard over the device mesh
(one halo exchange per sweep-batch), then drive N sweep-batches
device-side with soda_tpu.chained — ONE dispatch for the whole run,
arrays stay resident and sharded.

Run: python examples/multichip_relaxation.py [H] [W] [BATCHES]
(on CPU: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8)
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import soda_tpu
from soda_tpu.parallel.spmd import ShardedExecutor

JACOBI4 = '''
kernel: jacobi
burst width: 64
unroll factor: 1
iterate: 4
border: preserve
cluster: none
input dram 0 float: u(512, *)
output dram 1 float: un(0, 0) =
  (u(0, 1) + u(1, 0) + u(0, -1) + u(-1, 0)) * 0.25f
'''


def main():
  h = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
  w = int(sys.argv[2]) if len(sys.argv) > 2 else 512
  batches = int(sys.argv[3]) if len(sys.argv) > 3 else 25

  stencil = soda_tpu.build_stencil(JACOBI4, tile_size=(w, 0))
  ex = ShardedExecutor(stencil, (h, w))  # all devices, 1-D mesh
  print('devices: %d, %d sweeps per batch, %d batches -> %d sweeps' %
        (len(jax.devices()), stencil.iterate, batches,
         stencil.iterate * batches))

  # border: preserve freezes the whole invalid ring (width = the
  # 4-sweep halo), exactly like the reference's untiling — so the
  # Dirichlet condition is the 4-column hot band on the left
  u0 = jnp.zeros((h, w), jnp.float32).at[:, :4].set(1.0)
  run = soda_tpu.chained(ex, batches)  # ONE dispatch for all batches
  (u_final,) = run(*ex.prepare({'u': u0}))
  u_final = np.asarray(u_final)
  print('mean temperature: %.6f' % u_final.mean())
  print('interior sample [h/2, :8]:', np.round(u_final[h // 2, :8], 4))


if __name__ == '__main__':
  main()
