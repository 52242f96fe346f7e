"""The example registry (counterpart of ilqgames_tpu/examples/__init__.py):
the JAX package's 18 names, each the name of a reference exec binary.
`get(name)` returns the builder of a ported example, (dt=None,
num_time_steps=None) -> Problem; a name not yet ported raises
NotImplementedError that names it, and an unknown name KeyError."""

from __future__ import annotations

import importlib
from typing import Dict, Optional

_PKG = "ilqgames_tpu_torch.examples"

# name -> "module:function" of the port, or None where not yet ported.
_REGISTRY: Dict[str, Optional[str]] = {
    "three_player_intersection": "three_player_intersection:make_problem",
    "three_player_flat_intersection":
        "three_player_flat_intersection:make_problem",
    "two_player_collision": "two_player_collision:make_problem",
    "air_3d": "air_3d:make_problem",
    "dubins_origin": "dubins_origin:make_problem",
    "one_player_reachability": "reachability:make_one_player",
    "two_player_reachability": "reachability:make_two_player",
    "three_player_collision_avoidance_reachability":
        "reachability:make_three_player_collision_avoidance",
    "three_player_overtaking": "three_player_overtaking:make_problem",
    "roundabout_merging": "roundabout_merging:make_problem",
    "three_player_flat_overtaking":
        "three_player_flat_overtaking:make_problem",
    "modified_three_player_intersection":
        "modified_intersection:make_problem",
    "three_player_intersection_reachability":
        "modified_intersection:make_reachability",
    "modified_air_3d": "more_reachability:make_modified_air_3d",
    "two_player_collision_avoidance_reachability":
        "more_reachability:make_two_player_collision_avoidance",
    "flat_roundabout_merging": "flat_roundabout_merging:make_problem",
    "skeleton": "skeleton:make_problem",
    "two_player_point_mass": "two_player_point_mass:make_problem",
}


def get(name: str):
    """The named example's builder (its module imported on first use)."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown example '{name}'; available: {sorted(_REGISTRY)}")
    target = _REGISTRY[name]
    if target is None:
        raise NotImplementedError(
            f"example '{name}' is not ported to ilqgames_tpu_torch yet")
    module, fn = target.split(":")
    return getattr(importlib.import_module(f"{_PKG}.{module}"), fn)


def names():
    return sorted(_REGISTRY)


def ported():
    """The names whose builders `get` returns."""
    return sorted(n for n, t in _REGISTRY.items() if t is not None)
