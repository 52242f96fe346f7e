"""Batch-major <-> batch-minor layout helpers (counterpart of
ilqgames_tpu/ops/pallas/layout.py).

The kernels take batch-minor arrays ([..., B]: neighbouring lanes at
neighbouring addresses, so one thread per lane reads coalesced); the
solver around them is batch-major ([B, ...]).
"""

from __future__ import annotations

import torch


def bm(a: torch.Tensor) -> torch.Tensor:
    """Batch-major -> batch-minor (contiguous)."""
    return torch.movedim(a, 0, -1).contiguous()


def mb(a: torch.Tensor, Bt: int) -> torch.Tensor:
    """Batch-minor -> batch-major, trimming padded lanes to Bt."""
    return torch.movedim(a[..., :Bt], -1, 0)


def pad_batch(arr: torch.Tensor, Bb: int) -> torch.Tensor:
    """Pad the trailing batch axis to a multiple of Bb by replicating the
    last lane (a real lane cannot produce the NaNs that zeros might)."""
    pad = (-arr.shape[-1]) % Bb
    if pad == 0:
        return arr
    return torch.cat(
        [arr, arr[..., -1:].expand(arr.shape[:-1] + (pad,))], dim=-1)
