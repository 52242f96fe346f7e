"""The port's device-independent float32 sin, cos and tan (`fmath`, which
the dynamics and the rollout kernel share) against float64 numpy, over
the angles the flagship's rollouts reach and far beyond them."""

import numpy as np
import pytest
import torch

from ilqgames_tpu_torch import fmath

torch.set_num_threads(1)


def _angles():
    rng = np.random.RandomState(0)
    return np.concatenate([
        rng.uniform(-4.0, 4.0, 20000), rng.uniform(-8000.0, 8000.0, 20000),
        np.linspace(-np.pi, np.pi, 2001), [0.0, -0.0, 1e-30, -1e-30],
    ]).astype(np.float32)


@pytest.mark.parametrize("name", ["sin", "cos", "tan"])
def test_fmath_accuracy(name):
    """Within 1e-6 of the true value for sin and cos; within 4 float32
    ulps of it for tan away from its poles."""
    x = _angles()
    got = getattr(fmath, name)(torch.tensor(x)).double().numpy()
    ref = getattr(np, name)(x.astype(np.float64))
    if name == "tan":
        keep = np.abs(np.cos(x.astype(np.float64))) > 1e-2
        ulp = np.spacing(np.abs(ref[keep]).astype(np.float32))
        assert np.max(np.abs(got[keep] - ref[keep]) / ulp) <= 4.0
    else:
        assert np.max(np.abs(got - ref)) <= 1e-6


@pytest.mark.parametrize("name", ["sin", "cos", "tan"])
def test_fmath_large_arguments(name):
    """Beyond 8192 rad (the headings of diverged lanes): within 1e-6 of the
    true value up to 1e9 rad (tan: away from its poles), and sin and cos
    within [-1, 1] for every finite float32, up to the largest."""
    rng = np.random.RandomState(2)
    mid = np.concatenate([rng.uniform(8192.0, 1e9, 20000),
                          -rng.uniform(8192.0, 1e9, 20000)]).astype(np.float32)
    huge = np.concatenate([10.0 ** rng.uniform(9.0, 38.5, 20000),
                           [3.4028235e38, -3.4028235e38]]).astype(np.float32)
    fn = getattr(fmath, name)
    got = fn(torch.tensor(mid)).double().numpy()
    ref = getattr(np, name)(mid.astype(np.float64))
    if name == "tan":
        keep = np.abs(np.cos(mid.astype(np.float64))) > 0.1
        np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-5,
                                   atol=1e-6)
    else:
        assert np.max(np.abs(got - ref)) <= 1e-6
        assert np.abs(fn(torch.tensor(huge)).numpy()).max() <= 1.0
    assert bool(torch.isfinite(fn(torch.tensor(huge))).all())


def test_fmath_special_values():
    """Zeros map to sin 0, cos 1, tan 0; NaN and infinities give NaN."""
    x = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf")])
    for fn, at_zero in ((fmath.sin, 0.0), (fmath.cos, 1.0), (fmath.tan, 0.0)):
        y = fn(x)
        assert torch.equal(y[:2], torch.full((2,), at_zero))
        assert bool(torch.isnan(y[2:]).all())


def test_fmath_sqrt_correctly_rounded():
    """Bit for bit numpy's correctly rounded float32 sqrt, over the squared
    distances the proximity constraint sees and the whole exponent range."""
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.uniform(0.0, 400.0, 100000),
                        10.0 ** rng.uniform(-12.0, 37.0, 100000),
                        [0.0, 1e-12, 1.0, 4.0]]).astype(np.float32)
    np.testing.assert_array_equal(fmath.sqrt(torch.tensor(x)).numpy(),
                                  np.sqrt(x))
