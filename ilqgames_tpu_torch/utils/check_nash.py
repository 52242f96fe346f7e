"""Nash-equilibrium oracles (counterpart of ilqgames_tpu/utils/check_nash.py:
`compute_strategy_costs` at :29 and `numerical_check_local_nash` at :83),
in plain PyTorch.

`compute_strategy_costs` plays strategies from x0 with Euler steps and
sums each player's stage costs (the reference's ComputeStrategyCosts,
src/compute_strategy_costs.cpp:60-105); the open-loop variant plays the
alphas alone (no state feedback) and evaluates state costs at the next
state and time (EvaluateOffset). `numerical_check_local_nash` perturbs
every real alpha coordinate of every player at every knot but the last
by +/- a step and refutes the local Nash property if any perturbation
lowers the perturbing player's cost
(src/check_local_nash_equilibrium.cpp:60-131). All perturbations are
rolled out at once, as a batch. These run on any device; they are test
oracles, not part of the solver's path.
"""

from __future__ import annotations

import torch

from ilqgames_tpu_torch.types import GameSpec, OperatingPoint, Strategy


def _strategy_costs(dyn, player_costs, spec: GameSpec, Ps, alphas,
                    op: OperatingPoint, x0, open_loop: bool):
    """Per-player totals [M, P] of M plays: Ps [N, P, u, x] (shared),
    alphas [M, N, P, u], from x0 [x] about the operating point op."""
    N = spec.num_time_steps
    M = alphas.shape[0]
    u_mask = spec.u_mask(x0.device)
    steps = N - 1 if open_loop else N
    x = x0.expand(M, -1)
    t = torch.zeros((), dtype=torch.float32, device=x0.device)
    total = None
    for k in range(steps):
        delta = torch.zeros_like(x) if open_loop else x - op.xs[k]
        us = (op.us[k] - torch.einsum("pux,mx->mpu", Ps[k], delta)
              - alphas[:, k]) * u_mask
        x_next = x + spec.dt * dyn.ode(t, x, us)
        t_next = t + spec.dt
        if open_loop:
            costs = []
            for pc in player_costs:
                c = torch.zeros_like(x[:, 0])
                for sc in pc.state_costs:
                    c = c + sc.evaluate(t_next, x_next)
                for j, cc in pc.control_costs:
                    c = c + cc.evaluate(t, us[:, j])
                costs.append(c)
        else:
            costs = [pc.evaluate_stage(t, x, us) for pc in player_costs]
        stage = torch.stack(costs, -1)
        total = stage if total is None else total + stage
        x, t = x_next, t_next
    return total


def compute_strategy_costs(dyn, player_costs, spec: GameSpec,
                           strategy: Strategy, op: OperatingPoint,
                           x0: torch.Tensor,
                           open_loop: bool = False) -> torch.Tensor:
    """Per-player total cost [P] of playing `strategy` (one instance:
    Ps [N, P, u, x], alphas [N, P, u]) from x0 [x] (Euler rollouts)."""
    return _strategy_costs(dyn, player_costs, spec, strategy.Ps,
                           strategy.alphas[None], op, x0, open_loop)[0]


def numerical_check_local_nash(dyn, player_costs, spec: GameSpec,
                               strategy: Strategy, op: OperatingPoint,
                               x0: torch.Tensor,
                               max_perturbation: float = 0.1,
                               open_loop: bool = False) -> bool:
    """True iff no single-coordinate alpha perturbation of size
    +/- max_perturbation improves the perturbing player's cost."""
    N, P, um = spec.num_time_steps, spec.num_players, spec.umax
    nominal = compute_strategy_costs(dyn, player_costs, spec, strategy, op,
                                     x0, open_loop)
    cases = [(i, k, j, sign) for i in range(P) for k in range(N - 1)
             for j in range(spec.udims[i]) for sign in (-1.0, 1.0)]
    alphas = strategy.alphas[None].repeat(len(cases), 1, 1, 1)
    for n, (i, k, j, sign) in enumerate(cases):
        alphas[n, k, i, j] = alphas[n, k, i, j] + sign * max_perturbation
    costs = _strategy_costs(dyn, player_costs, spec, strategy.Ps, alphas,
                            op, x0, open_loop)
    who = torch.tensor([c[0] for c in cases], device=costs.device)
    improvement = nominal[who] - costs[torch.arange(len(cases)), who]
    return bool((improvement <= 0.0).all())
