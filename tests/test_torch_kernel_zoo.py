"""The port's kernel zoo (repro_torch.core.kernels) against repro.core.kernels.

Same r values (numpy, seeded) through both; every k0..k3 and effective
coefficient k1e..k3e of all nine kernels must agree to 1e-12 relative at
float64 (both evaluate the same closed forms).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernels import get_kernel as jax_kernel
from repro.core.kernels import kernel_names as jax_kernel_names
from repro_torch.core.kernels import get_kernel, kernel_names

TOL = 1e-12


def _r(stationary: bool) -> np.ndarray:
    rs = np.random.RandomState(0)
    if stationary:  # squared distances, including the clamped r = 0 edge
        return np.concatenate([[0.0, 1e-14, 1e-3], rs.rand(40) * 6.0])
    return np.concatenate([[0.0, -1.5, 2.0], rs.randn(40) * 1.5])


def test_same_kernel_names():
    assert kernel_names() == jax_kernel_names()


@pytest.mark.parametrize("name", jax_kernel_names())
def test_kernel_zoo_matches_jax(name):
    kj, kt = jax_kernel(name), get_kernel(name)
    assert (kt.name, kt.family, kt.grad_ok) == (kj.name, kj.family, kj.grad_ok)
    r = _r(kj.is_stationary)
    rj, rt = jnp.asarray(r), torch.tensor(r, dtype=torch.float64)
    for fn in ("k0", "k1", "k2", "k3", "k1e", "k2e", "k3e"):
        want = np.asarray(getattr(kj, fn)(rj))
        got = getattr(kt, fn)(rt).numpy()
        assert got.dtype == np.float64
        scale = np.maximum(np.abs(want), 1e-300)
        err = float(np.max(np.abs(got - want) / scale))
        assert err <= TOL, (name, fn, err)


def test_rq_alpha_and_unknown_kernel():
    kj, kt = jax_kernel("rq", alpha=0.5), get_kernel("rq", alpha=0.5)
    r = _r(True)
    assert kt.name == kj.name == "rq0.5"
    np.testing.assert_allclose(kt.k2e(torch.tensor(r)).numpy(),
                               np.asarray(kj.k2e(jnp.asarray(r))), rtol=TOL)
    with pytest.raises(KeyError):
        get_kernel("nope")
