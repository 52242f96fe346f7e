"""Nash-equilibrium oracles (counterpart of ilqgames_tpu/utils/check_nash.py:
`compute_strategy_costs` at :29, `numerical_check_local_nash` at :83,
`change_cost_coordinates` at :124 and `check_sufficient_local_nash` at
:152), in plain PyTorch.

`compute_strategy_costs` plays strategies from x0 with Euler steps and
sums each player's stage costs (the reference's ComputeStrategyCosts,
src/compute_strategy_costs.cpp:60-105); the open-loop variant plays the
alphas alone (no state feedback) and evaluates state costs at the next
state and time (EvaluateOffset). `numerical_check_local_nash` perturbs
every real alpha coordinate of every player at every knot but the last
by +/- a step and refutes the local Nash property if any perturbation
lowers the perturbing player's cost
(src/check_local_nash_equilibrium.cpp:60-131). All perturbations are
rolled out at once, as a batch. `check_sufficient_local_nash` checks
that every player's state and control Hessians along a trajectory are
positive semidefinite (:144-200), a flat system's state Hessians first
carried back to its nonlinear coordinates by the chain rule
(`change_cost_coordinates`, through torch.func's jacfwd and hessian where
the JAX package takes jax's). These run on any device; they are test
oracles, not part of the solver's path.
"""

from __future__ import annotations

import torch

from ilqgames_tpu_torch.costs import player_cost as pcost
from ilqgames_tpu_torch.types import GameSpec, OperatingPoint, Strategy, \
    tree_map


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


def change_cost_coordinates(dyn, quad_Q, quad_l, xis):
    """State Hessians and gradients carried from a flat system's
    linearizing coordinates xi to its nonlinear state x by the chain rule
    (the reference's ConcatenatedFlatSystem::ChangeCostCoordinates,
    src/concatenated_flat_system.cpp:246-330, whose hand-written partials
    are autodiff through to_linear_state here, as in the JAX package):

        H_x = J^T H_xi J + sum_i g_xi[i] Hess_x(to_linear_i),
        g_x = J^T g_xi,  J = d to_linear / dx at x = from_linear(xi).

    quad_Q [N, P, x, x], quad_l [N, P, x], xis [N, x] -> (Q_x, l_x)."""
    xs = dyn.from_linear_state(xis)
    # Forward-mode tangents of fmath's float64 range reduction come out in
    # float64; the chain rule is taken in float32, as in JAX.
    J = torch.func.vmap(torch.func.jacfwd(dyn.to_linear_state))(xs).to(
        xs.dtype)                                            # [N, xi, x]
    H2 = torch.func.vmap(torch.func.hessian(dyn.to_linear_state))(xs).to(
        xs.dtype)                                            # [N, xi, x, x]
    Q_x = (torch.einsum("kix,kpij,kjy->kpxy", J, quad_Q, J)
           + torch.einsum("kpi,kixy->kpxy", quad_l, H2))
    return Q_x, torch.einsum("kix,kpi->kpx", J, quad_l)


def check_sufficient_local_nash(player_costs, spec: GameSpec,
                                op: OperatingPoint, al=None,
                                error_margin: float = 1e-4,
                                dyn=None) -> bool:
    """Whether every state Hessian Q and control Hessian R of one
    instance's operating point is positive semidefinite within
    `error_margin` (the reference's CheckSufficientLocalNashEquilibrium,
    src/check_local_nash_equilibrium.cpp:144-200): the quadraticization
    at the multipliers `al` (one instance's ALState; the initial ones by
    default), MAX and MIN players' state terms gated at their extreme
    knots. For a flat system pass `dyn`: its state Hessians are carried
    back to the nonlinear coordinates first, as the reference does."""
    lane = lambda t: tree_map(lambda a: a[None], t)
    op_b = lane(op)
    al_b = (pcost.ALState.init(player_costs, spec, 1, device=op.xs.device)
            if al is None else lane(al))
    gate = None
    if not pcost.all_sum(player_costs):
        _, ks = pcost.total_costs(player_costs, spec, op_b)
        gate = pcost.extreme_gate(player_costs, spec, ks)
    quad = tree_map(lambda a: a[0], pcost.quadraticize(
        player_costs, spec, op_b, al_b, gate=gate))
    Q = quad.Q
    if dyn is not None and dyn.from_linear_state is not None:
        Q, _ = change_cost_coordinates(dyn, quad.Q, quad.l, op.xs)
    min_q = torch.linalg.eigvalsh(Q).min()
    # Control Hessians of pairs without a cost are zero matrices, whose
    # eigenvalues 0 pass.
    min_r = torch.linalg.eigvalsh(quad.R).min()
    return bool(min_q >= -error_margin) and bool(min_r >= -error_margin)
