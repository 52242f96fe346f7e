"""float32 sin, cos, tan and sqrt that round the same on every device.

The port's dynamics run on the CPU (plain versions), in PyTorch's CUDA
kernels and in the hand-written rollout kernel. Each has its own library
sine, and their last bits differ; along the diverged tail of a batch
those differences grow without bound and can flip a linesearch decision
between the card and the CPU. These functions use only IEEE-rounded
float32 +, -, *, / and floor, in a fixed order, so they give the same
bits wherever they run; csrc/fmath.cuh is the same sequence in CUDA
(built without FMA contraction).

`sqrt` is correctly rounded: PyTorch's vectorized CPU sqrt is not (it
differs from the correctly rounded result in the last bit on about 0.6%
of float32 inputs), while the card's is. The root is taken in float64
and rounded: a float64 root within an ulp of the exact one always rounds
to the correctly rounded float32 root.

Method for sin, cos and tan (Cephes sinf/cosf/tanf): reduce |x| by multiples of pi/4 with a
three-part Cody-Waite constant to r in [-pi/4, pi/4], then minimax
polynomials for sin(r) and cos(r) picked by octant. That reduction is
accurate for |x| < 8192 only, and beyond it its result grows without
bound (sin(1e14) came out as -inf), so larger arguments are first
reduced modulo the float64 value of 2*pi with fmod, which is exact on
every device, and rounded back to float32. Accuracy is within a few
float32 ulps for |x| < 8192 and within 1e-6 up to |x| ~ 1e9 (the float64
modulus differs from 2*pi by 2.4e-16, once per period); every finite
argument gives a value in [-1, 1].
"""

from __future__ import annotations

import torch

FOPI = 1.27323954473516  # 4 / pi
DP1 = 0.78515625
DP2 = 2.4187564849853515625e-4
DP3 = 3.77489497744594108e-8
LARGE = 8192.0
TWO_PI = 6.283185307179586  # float64 2*pi


def _large(x: torch.Tensor) -> torch.Tensor:
    """x, with arguments beyond +-LARGE replaced by their exact float64
    remainder modulo TWO_PI (rounded to float32), sign kept."""
    ax = torch.abs(x)
    red = torch.fmod(ax.double(), TWO_PI).to(x.dtype)
    return torch.where(ax > LARGE, torch.copysign(red, x), x)


def _reduce(x: torch.Tensor):
    """(r, q): |x| = r + (q + 8m) * pi/4 with q in {0, 2, 4, 6}."""
    ax = torch.abs(x)
    j = torch.floor(ax * FOPI)
    j = j + (j - 2.0 * torch.floor(j * 0.5))       # round up to even
    r = ((ax - j * DP1) - j * DP2) - j * DP3
    q = j - 8.0 * torch.floor(j * 0.125)
    return r, q


def _sin_poly(r: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return ((-1.9515295891e-4 * z + 8.3321608736e-3) * z
            - 1.6666654611e-1) * z * r + r


def _cos_poly(z: torch.Tensor) -> torch.Tensor:
    return (((2.443315711809948e-5 * z - 1.388731625493765e-3) * z
             + 4.166664568298827e-2) * z * z - 0.5 * z) + 1.0


def sin(x: torch.Tensor) -> torch.Tensor:
    x = _large(x)
    r, q = _reduce(x)
    z = r * r
    s, c = _sin_poly(r, z), _cos_poly(z)
    y = torch.where((q == 2.0) | (q == 6.0), c, s)
    y = torch.where(q >= 4.0, -y, y)
    return torch.where(x < 0.0, -y, y)


def cos(x: torch.Tensor) -> torch.Tensor:
    x = _large(x)
    r, q = _reduce(x)
    z = r * r
    s, c = _sin_poly(r, z), _cos_poly(z)
    y = torch.where((q == 2.0) | (q == 6.0), s, c)
    return torch.where((q == 2.0) | (q == 4.0), -y, y)


def tan(x: torch.Tensor) -> torch.Tensor:
    x = _large(x)
    r, q = _reduce(x)
    z = r * r
    s, c = _sin_poly(r, z), _cos_poly(z)
    y = torch.where((q == 2.0) | (q == 6.0), -(c / s), s / c)
    return torch.where(x < 0.0, -y, y)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).to(x.dtype)
