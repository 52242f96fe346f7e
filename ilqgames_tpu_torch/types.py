"""Core containers of the PyTorch port (counterpart of ilqgames_tpu/types.py).

Containers are plain dataclasses of tensors with a `replace` method.
Solver code keeps a leading batch axis on every tensor it carries (the
JAX package vmaps per-instance code instead); the shapes documented
below are per instance, and batched containers prepend [B].

Everything is float32. Per-player controls are padded to `umax`, and
`GameSpec.u_mask` marks the real entries, exactly as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

SMALL_NUMBER = 1e-4
DEFAULT_MU = 10.0
DEFAULT_TIME_STEP = 0.1
DEFAULT_TIME_HORIZON = 10.0
DEFAULT_NUM_TIME_STEPS = int(
    (DEFAULT_TIME_HORIZON + 0.5 * DEFAULT_TIME_STEP) / DEFAULT_TIME_STEP
)  # = 100


@dataclasses.dataclass(frozen=True)
class GameSpec:
    """Static description of an N-player game's shapes."""

    xdims: Tuple[int, ...]
    udims: Tuple[int, ...]
    dt: float = DEFAULT_TIME_STEP
    num_time_steps: int = DEFAULT_NUM_TIME_STEPS

    @property
    def num_players(self) -> int:
        return len(self.udims)

    @property
    def xdim(self) -> int:
        return sum(self.xdims)

    @property
    def umax(self) -> int:
        return max(self.udims)

    def u_mask(self, device=None) -> torch.Tensor:
        """[P, umax] mask: 1 where the padded control entry is real."""
        m = torch.zeros((self.num_players, self.umax), dtype=torch.float32,
                        device=device)
        for i, d in enumerate(self.udims):
            m[i, :d] = 1.0
        return m

    def horizon_times(self, device=None) -> torch.Tensor:
        """Relative times of each knot: k * dt."""
        return (torch.arange(self.num_time_steps, dtype=torch.float32,
                             device=device) * self.dt)


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class OperatingPoint(_Replace):
    """xs [N, xdim], us [N, P, umax], t0 scalar."""

    xs: torch.Tensor
    us: torch.Tensor
    t0: torch.Tensor

    @classmethod
    def zeros(cls, spec: GameSpec, t0: float = 0.0,
              device=None) -> "OperatingPoint":
        N, P = spec.num_time_steps, spec.num_players
        return cls(
            xs=torch.zeros((N, spec.xdim), dtype=torch.float32,
                           device=device),
            us=torch.zeros((N, P, spec.umax), dtype=torch.float32,
                           device=device),
            t0=torch.tensor(t0, dtype=torch.float32, device=device),
        )


@dataclasses.dataclass(frozen=True)
class Strategy(_Replace):
    """Affine feedback u_i(k) = u_ref_i(k) - Ps[k, i] dx - alphas[k, i].

    Ps [N, P, umax, xdim], alphas [N, P, umax]."""

    Ps: torch.Tensor
    alphas: torch.Tensor

    @classmethod
    def zeros(cls, spec: GameSpec, device=None) -> "Strategy":
        N, P, u = spec.num_time_steps, spec.num_players, spec.umax
        return cls(
            Ps=torch.zeros((N, P, u, spec.xdim), dtype=torch.float32,
                           device=device),
            alphas=torch.zeros((N, P, u), dtype=torch.float32,
                               device=device),
        )

    def scale_alphas(self, scaling) -> "Strategy":
        return self.replace(alphas=self.alphas * scaling)


@dataclasses.dataclass(frozen=True)
class LinearDynamics(_Replace):
    """A = I + dt*df/dx [N, x, x]; Bs_i = dt*df/du_i [N, P, x, umax]."""

    A: torch.Tensor
    Bs: torch.Tensor


@dataclasses.dataclass(frozen=True)
class QuadraticCosts(_Replace):
    """Q [N,P,x,x], l [N,P,x], R [N,P,P,u,u], r [N,P,P,u] (dense, padded)."""

    Q: torch.Tensor
    l: torch.Tensor
    R: torch.Tensor
    r: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LQSolution(_Replace):
    """strategy, delta_xs [N, x]. The production path never consumes
    costates, so the port does not carry them."""

    strategy: Strategy
    delta_xs: torch.Tensor


def const_tensor(values: tuple, device: torch.device) -> torch.Tensor:
    """A small constant tensor (index columns, masks) on `device`, made
    once per device: every copy from host memory to the card waits for
    the card to drain its queue. Callers must not write to it. The cache
    keys on the values' types too: (0,) and (0.0,) are equal tuples, but
    one makes an index tensor and the other a float one."""
    return _const_tensor(values, tuple(map(type, values)), device)


@functools.lru_cache(maxsize=None)
def _const_tensor(values: tuple, types: tuple,
                  device: torch.device) -> torch.Tensor:
    return torch.tensor(values, device=device)


def tree_map(fn, *trees):
    """Apply `fn` leaf-wise over matching dataclass / tuple structures
    whose leaves are tensors (the port's stand-in for jax.tree_util)."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return dataclasses.replace(t0, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    if isinstance(t0, tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    out = []
    tree_map(lambda a: out.append(a), tree)
    return out
