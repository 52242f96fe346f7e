"""Matplotlib visualization (counterpart of ilqgames_tpu/viz.py): top-down
trajectory rendering and per-cost plots — the capability of the reference's DearImGui GUI (TopDownRenderer,
src/top_down_renderer.cpp; CostInspector, src/cost_inspector.cpp) in
batch/headless form. The interactive slider workflow becomes "pick an
iterate index"; heading triangles match the reference's marker style.
matplotlib is imported inside the plotting functions only: importing this
module needs numpy alone, and a plot without matplotlib raises its
ImportError."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import torch

from ilqgames_tpu_torch.utils.cost_cache import PlayerCostCache
from ilqgames_tpu_torch.utils.solver_log import SolverLog


def _agent_xy_theta(problem, xs: np.ndarray):
    """Per-player (x, y, theta-if-known) tracks from the joint state.

    For flat systems, headings come from from_linear_state (reference
    TopDownRenderableProblem::Thetas via FromLinearSystemState)."""
    dyn = problem.dynamics
    if dyn.from_linear_state is not None:
        xs = dyn.from_linear_state(torch.as_tensor(xs)).numpy()
    out = []
    offset = 0
    for i, xd in enumerate(problem.spec.xdims):
        px, py = dyn.position_dims[i]
        theta = None
        # Heading convention: all bundled models with a heading store it at
        # sub-state index 2.
        if xd >= 3:
            theta = xs[:, offset + 2]
        out.append((xs[:, px], xs[:, py], theta))
        offset += xd
    return out


def plot_top_down(
    problem,
    log: SolverLog,
    iterate: Optional[int] = None,
    ax=None,
    show_markers: bool = True,
):
    """Top-down trajectory plot of one solver iterate."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(7, 7))
    iterate = log.num_iterates - 1 if iterate is None else iterate
    xs = np.asarray(log.operating_points[iterate].xs)

    for i, (px, py, theta) in enumerate(_agent_xy_theta(problem, xs)):
        (line,) = ax.plot(px, py, label=f"P{i + 1}")
        if show_markers and theta is not None:
            for k in range(0, len(px), max(1, len(px) // 12)):
                ax.plot(
                    px[k], py[k],
                    marker=(3, 0, np.degrees(theta[k]) - 90),
                    markersize=8, color=line.get_color(), linestyle="",
                )
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.legend()
    ax.set_title(f"{problem.name}: iterate {iterate}")
    return ax


def plot_costs(
    problem,
    log: SolverLog,
    player: int,
    names: Optional[Sequence[str]] = None,
    iterate: Optional[int] = None,
    ax=None,
):
    """Cost-vs-time plot for one player at one iterate (CostInspector)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(7, 4))
    iterate = log.num_iterates - 1 if iterate is None else iterate
    cache = PlayerCostCache(problem, log)
    ts = problem.spec.horizon_times().numpy()
    for name in names or cache.names(player):
        ax.plot(ts, cache.evaluate(iterate, player, name), label=name)
    ax.set_xlabel("t (s)")
    ax.set_ylabel("stage cost")
    ax.legend(fontsize=7)
    ax.set_title(f"{problem.name}: P{player + 1} costs, iterate {iterate}")
    return ax
