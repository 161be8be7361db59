"""Example: run a Jacobi relaxation to convergence on the device.

Shows the production pattern for iterative stencils: compile ONE
multi-sweep executor (here 4 sweeps per launch), then drive it from a
jit'd while_loop until the residual drops below tolerance. Everything
stays on device.

Run: python examples/iterative_solver.py [H] [W]
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

import pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from soda_tpu import build_stencil, get_executor

SWEEPS_PER_LAUNCH = 4

JACOBI = '''
kernel: jacobi
burst width: 64
unroll factor: 1
iterate: %d
border: preserve
cluster: none
input dram 0 float: u(512, *)
output dram 1 float: un(0, 0) =
  (u(0, 1) + u(1, 0) + u(0, -1) + u(-1, 0)) * 0.25f
''' % SWEEPS_PER_LAUNCH


def main():
  h = int(sys.argv[1]) if len(sys.argv) > 1 else 512
  w = int(sys.argv[2]) if len(sys.argv) > 2 else 512

  stencil = build_stencil(JACOBI, tile_size=(w, 0))
  ex = get_executor(stencil, (h, w))
  print('executor: %s (block_rows=%s)' %
        (type(ex).__name__, getattr(ex, 'block_rows', 'n/a')))

  # boundary conditions: hot left edge, cold elsewhere; border:
  # preserve keeps them fixed across sweeps
  u0 = jnp.zeros((h, w), jnp.float32)
  u0 = u0.at[:, 0].set(1.0)

  @jax.jit
  def solve(u):
    def cond(state):
      _, residual, it = state
      return jnp.logical_and(residual > 1e-5, it < 512)

    def body(state):
      u, _, it = state
      (nxt,) = ex.fn(u)
      residual = jnp.max(jnp.abs(nxt - u))
      return nxt, residual, it + SWEEPS_PER_LAUNCH

    return jax.lax.while_loop(cond, body, (u, jnp.float32(1.0), 0))

  u, residual, iters = solve(u0)
  jax.block_until_ready(u)
  print('converged to residual %.2e after %d sweeps' %
        (float(residual), int(iters)))
  print('interior mean %.4f (expect > 0: heat diffused from the edge)' %
        float(jnp.mean(u[1:-1, 1:-1])))
  assert float(jnp.mean(u[1:-1, 1:-1])) > 0


if __name__ == '__main__':
  main()
