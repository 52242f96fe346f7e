"""Solver parameters (counterpart of ilqgames_tpu/solver/params.py).

The same frozen dataclass with the same defaults, so one parameter set
drives both packages.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverParams:
    # Convergence: merit decreased and |delta merit| below tolerance.
    convergence_tolerance: float = 1e-1
    max_solver_iters: int = 1000

    # Armijo linesearch.
    linesearch: bool = True
    initial_alpha_scaling: float = 0.5
    geometric_alpha_scaling: float = 0.5
    max_backtracking_steps: int = 10
    expected_decrease_fraction: float = 0.1

    # Open-loop vs feedback Nash.
    open_loop: bool = False

    # State and control regularization (added in PlayerCost construction).
    state_regularization: float = 0.0
    control_regularization: float = 0.0

    # Augmented Lagrangian.
    unconstrained_solver_max_iters: int = 10
    geometric_mu_scaling: float = 1.1
    geometric_mu_downscaling: float = 0.5
    geometric_lambda_downscaling: float = 0.5
    constraint_error_tolerance: float = 1e-1
    max_al_iters: int = 100

    # Reset behavior after an AL solve.
    reset_problem: bool = True
    reset_lambdas: bool = True
    reset_mu: bool = True

    # LQ kernel regularization (Gershgorin).
    adaptive_regularization: bool = True

    # Phase-1 (full-batch) candidate width of the batched linesearch.
    linesearch_chunk: int = 1

    # Candidate window of each compact deep-ladder round.
    linesearch_deep_chunk: int = 8

    # Candidates past this index are merit-evaluated as the last evaluated
    # one (the geometric ladder collapses in float32); 0 disables the cap.
    linesearch_eval_cap: int = 40
