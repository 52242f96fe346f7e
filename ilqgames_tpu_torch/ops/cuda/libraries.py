"""A game's kernel libraries: which (source, defines) pairs it needs, and
building and loading them all at once, with the float32 precision the
solves run at. The entry points (`problem.Problem.prepare`, the bench)
call these before a solve on the card.
"""

from __future__ import annotations

import torch

from ilqgames_tpu_torch.ops.cuda import build, lq, lq_open_loop, stage, \
    sweep
from ilqgames_tpu_torch.ops.cuda.cost_table import MAX_ATOMS, has_table


def set_precision() -> None:
    """Full float32 everywhere: the JAX package forces f32 matmul
    precision, so the port allows no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def kernel_libraries(dyn, spec, player_costs=(), open_loop=False) -> list:
    """The (source, defines) of every kernel library of the port for this
    game, in the order K1, K2/K3, K6, K4, K5 (K4 and K5 one library where
    the game's merit needs no flag), then K7's with `open_loop`: K1 with
    the game's atoms and Jacobians (`stage.features`), K5 and K6 with its
    merit's atoms (`sweep.merit_features`: the norm atoms, the
    reachability features, quadratic_difference, semiquadratic, a table
    of more than MAX_ATOMS atoms); K4 takes none of them. A game whose
    costs have no device form (`cost_table.has_table`: it runs unfused
    with the merit backend "xla") gets K2/K3's and K4's (and K7's)
    only."""
    if not has_table(player_costs, spec):
        return ([lq.library(spec), sweep.library(dyn, spec)]
                + ([lq_open_loop.library(spec)] if open_loop else []))
    mf = sweep.merit_features(player_costs, spec)
    plain = dict({k: False for k in mf}, atoms=MAX_ATOMS)
    sweeps = [plain] + ([mf] if mf != plain else [])
    return ([stage.library(spec, **stage.features(dyn, player_costs, spec)),
             lq.library(spec), sweep.merit_library(spec, **mf)]
            + [sweep.library(dyn, spec, **f) for f in sweeps]
            + ([lq_open_loop.library(spec)] if open_loop else []))


def build_kernels(dyn, spec, player_costs=(), open_loop=False) -> None:
    """Build every kernel library of the game (`kernel_libraries`; one
    concurrent nvcc per source) and load them."""
    build.compile_all(kernel_libraries(dyn, spec, player_costs, open_loop))
    if not has_table(player_costs, spec):
        lq.load_kernels(spec)
        sweep.load_kernels(dyn, spec)
        if open_loop:
            lq_open_loop.load_kernels(spec)
        return
    mf = sweep.merit_features(player_costs, spec)
    stage.load_kernels(spec, **stage.features(dyn, player_costs, spec))
    lq.load_kernels(spec)
    sweep.load_merit_kernel(spec, **mf)
    sweep.load_kernels(dyn, spec)
    sweep.load_kernels(dyn, spec, **mf)
    if open_loop:
        lq_open_loop.load_kernels(spec)
