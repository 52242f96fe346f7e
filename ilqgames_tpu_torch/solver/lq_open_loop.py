"""Open-loop Nash LQ solve on the batched machine's containers
(counterpart of ilqgames_tpu/solver/lq_open_loop.py, which the JAX
package's batched machine vmaps, batched.py:276-285).

Strategies come back in affine feedback form with P == 0 and alpha the
open-loop control's negation (the terminal rows zero, as the JAX
package's), so the rollout, the merit sweep and the reroll of the
feedback path take them unchanged. The sweep itself is kernel K7
(ops/cuda/lq_open_loop.py). The JAX package also returns costates,
which nothing downstream reads; the port's LQSolution carries none.
"""

from __future__ import annotations

import torch

from ilqgames_tpu_torch.ops.cuda import lq, lq_open_loop
from ilqgames_tpu_torch.ops.cuda.layout import bm, mb, pad_batch
from ilqgames_tpu_torch.types import GameSpec, LinearDynamics, LQSolution, \
    QuadraticCosts, Strategy


def solve_lq_open_loop(spec: GameSpec, lin: LinearDynamics,
                       quad: QuadraticCosts, dx0: torch.Tensor,
                       batch_block: int = 128) -> LQSolution:
    """The open-loop LQ game of every lane on batch-major containers
    (lin.A [Bt, N, x, x], lin.Bs [Bt, N, P, x, u], quad batched, dx0
    [Bt, x]), lanes padded to a multiple of `batch_block` for K7."""
    N, P, x, u = spec.num_time_steps, spec.num_players, spec.xdim, spec.umax
    Bt = dx0.shape[0]
    al_r, dxs = lq_open_loop.lq_open_loop(
        spec, lq.lq_operands(spec, lin, quad, batch_block),
        pad_batch(bm(dx0), batch_block).contiguous())
    alphas = mb(al_r, Bt).reshape(Bt, N - 1, P, u)
    return LQSolution(
        strategy=Strategy(
            Ps=dx0.new_zeros((Bt, N, P, u, x)),
            alphas=torch.cat([alphas, alphas.new_zeros((Bt, 1, P, u))],
                             dim=1)),
        delta_xs=mb(dxs, Bt))
