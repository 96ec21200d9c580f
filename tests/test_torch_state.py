"""The port's streaming gradient-GP slice against the JAX package.

A ``repro.core.GPGState`` and a ``repro_torch`` ``GPGState`` on the CPU are
fed the same observations (numpy, seeded) with a window of 4, so the
window evicts; after every extend Z, L, K1e and count must agree, then the
serve step's value and grad on a ragged 10-query batch. Both run the exact
method at float64 with CG at tol 1e-10; the two solves differ only in
summation order (XLA vs PyTorch), which the well-conditioned random walk
below keeps far under the 1e-8 relative bound.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_gp import GPServeConfig as JaxServeConfig
from repro.core import GPGState as JaxState
from repro.core import GramFactors as JaxFactors
from repro.core import get_kernel as jax_kernel
from repro.core import posterior_batch as jax_posterior_batch
from repro.core import solvers as jsolvers
from repro.core import state as jstate
from repro.train.serve import build_gp_serve_step as jax_serve_step
from repro_torch import (GPGState, GPServeConfig, GramFactors, build_gp_serve_step,
                         convert, get_kernel, posterior_batch)
from repro_torch.core import solvers, state

D = 300
WINDOW = 4
NOISE = 1e-6
TOL = 1e-8
KERNELS = ["rbf", "matern52", "poly2", "expdot"]


def _walk(seed, n, d=D, step=1.0):
    """n points of a seeded random walk and their gradients under the
    README's test function f(x) = sum(sin(x) * roll(x, 1)) / D."""
    rs = np.random.RandomState(seed)
    x = rs.randn(d)
    out = []
    for _ in range(n):
        g = (np.cos(x) * np.roll(x, 1) + np.roll(np.sin(x), -1)) / d
        out.append((x.copy(), g))
        x = x + step * rs.randn(d)
    return out, x


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(float(np.linalg.norm(want)), 1e-300))


def _states(kname, **kw):
    js = JaxState(kname, d=D, window=WINDOW, lam=1.0 / D, noise=NOISE,
                  tol=1e-10, **kw)
    ts = GPGState(kname, d=D, window=WINDOW, lam=1.0 / D, noise=NOISE,
                  tol=1e-10, dtype=torch.float64, device="cpu", **kw)
    return js, ts


def _assert_same(js, ts, fields=("Z", "L", "K1e", "K2e", "X", "G")):
    assert int(js.data.count) == ts.data.count
    for k in fields:
        err = _rel(getattr(ts.data, k).numpy(), getattr(js.data, k))
        assert err <= TOL, (k, err)


@functools.lru_cache(maxsize=None)
def _served(kname):
    """Both states after the same 3-step walk: the state that the serve
    tests query and never change. The cases of one kernel that land on
    one test worker share it, since each JAX extend compiles anew."""
    obs, x_last = _walk(4, 3)
    js, ts = _states(kname)
    for x, g in obs:
        js.extend(jnp.asarray(x), jnp.asarray(g))
        ts.extend(torch.tensor(x), torch.tensor(g))
    return x_last, js, ts


@pytest.mark.parametrize("kname", KERNELS)
def test_extend_evict_serve_trajectory_matches_jax(kname):
    """Five steps through a window of 4: the fifth evicts."""
    obs, x_last = _walk(0, 5)
    js, ts = _states(kname)
    for x, g in obs:
        js.extend(jnp.asarray(x), jnp.asarray(g))
        ts.extend(torch.tensor(x), torch.tensor(g))
        _assert_same(js, ts)
    assert ts.stats["n_solve"] == 5 and ts.stats["n_refactor"] == 0
    Xq = x_last[None] + 0.1 * np.random.RandomState(1).randn(10, D)
    pj = jax_serve_step(js, config=JaxServeConfig(microbatch=4)).query(
        jnp.asarray(Xq))
    pt = build_gp_serve_step(ts, config=GPServeConfig(microbatch=4),
                             device="cpu").query(torch.tensor(Xq))
    assert tuple(pt.grad.shape) == (10, D) and tuple(pt.value.shape) == (10,)
    assert _rel(pt.value.numpy(), pj.value) <= TOL
    assert _rel(pt.grad.numpy(), pj.grad) <= TOL
    assert ts.stats["n_solve"] == 5  # queries never re-solve


def test_dot_kernel_center_matches_jax():
    obs, x_last = _walk(10, 4)
    c = 0.3 * np.ones(D)
    js = JaxState("poly2", d=D, window=WINDOW, lam=1.0 / D, noise=NOISE,
                  tol=1e-10, c=jnp.asarray(c))
    ts = GPGState("poly2", d=D, window=WINDOW, lam=1.0 / D, noise=NOISE,
                  tol=1e-10, c=torch.tensor(c), dtype=torch.float64,
                  device="cpu")
    for x, g in obs:
        js.extend(jnp.asarray(x), jnp.asarray(g))
        ts.extend(torch.tensor(x), torch.tensor(g))
        _assert_same(js, ts, fields=("Z", "L", "K1e", "Xt"))
    Xq = x_last[None] + 0.1 * np.random.RandomState(11).randn(3, D)
    pj, pt = js.posterior(jnp.asarray(Xq)), ts.posterior(torch.tensor(Xq))
    assert _rel(pt.value.numpy(), pj.value) <= TOL
    assert _rel(pt.grad.numpy(), pj.grad) <= TOL


@pytest.mark.parametrize("kname,microbatch", [
    ("rbf", 1), ("rbf", 3), ("rbf", 16), ("matern52", 3), ("poly2", 3),
    ("poly2", 7), ("expdot", 7)])
def test_serve_microbatch_split_matches_jax(kname, microbatch):
    """The port runs a ragged last microbatch as it is (the JAX step pads
    it): any split of a request gives the JAX answer."""
    x_last, js, ts = _served(kname)
    Xq = x_last[None] + 0.1 * np.random.RandomState(5).randn(10, D)
    cfg = dict(microbatch=microbatch)
    pj = jax_serve_step(js, config=JaxServeConfig(**cfg)).query(
        jnp.asarray(Xq))
    pt = build_gp_serve_step(ts, config=GPServeConfig(**cfg),
                             device="cpu").query(torch.tensor(Xq))
    assert tuple(pt.grad.shape) == (10, D) and tuple(pt.value.shape) == (10,)
    assert _rel(pt.value.numpy(), pj.value) <= TOL
    assert _rel(pt.grad.numpy(), pj.grad) <= TOL


@pytest.mark.parametrize("kname", ["rbf", "poly2"])
def test_bf16_stream_queries_match_jax(kname):
    """posterior_batch(precision='bf16'): the shifted (stationary) or
    centered (dot) frame, then bf16 streams and f32 accumulation. Both
    packages quantize the same f32 values, so only the f32 summation
    order differs (1e-5 relative)."""
    rs = np.random.RandomState(12)
    Xt = (3.0 + rs.randn(4, D)).astype(np.float32)
    Z = rs.randn(4, D).astype(np.float32)
    Xq = (3.0 + rs.randn(6, D)).astype(np.float32)
    c = None if kname == "rbf" else np.full(D, 0.5, np.float32)
    lam = np.float32(1.0 / D)
    zeros = np.zeros((4, 4), np.float32)
    jf = JaxFactors(K1e=jnp.asarray(zeros), K2e=jnp.asarray(zeros),
                    Xt=jnp.asarray(Xt), lam=jnp.asarray(lam),
                    c=None if c is None else jnp.asarray(c))
    tf = GramFactors(K1e=torch.tensor(zeros), K2e=torch.tensor(zeros),
                     Xt=torch.tensor(Xt), lam=torch.tensor(lam),
                     c=None if c is None else torch.tensor(c))
    pj = jax_posterior_batch(jax_kernel(kname), jnp.asarray(Xq), jf,
                             jnp.asarray(Z), microbatch=4, precision="bf16")
    pt = posterior_batch(get_kernel(kname), torch.tensor(Xq), tf,
                         torch.tensor(Z), microbatch=4, precision="bf16")
    assert pt.grad.dtype == torch.float32
    assert _rel(pt.value.numpy(), pj.value) <= 1e-5
    assert _rel(pt.grad.numpy(), pj.grad) <= 1e-5


@pytest.mark.parametrize("kname", ["rbf", "expdot"])
def test_state_carried_across_from_jax_continues_alike(kname):
    """A JAX state's data after 2 extends, carried into the port, goes on
    as the JAX state goes on, past the window's first eviction."""
    obs, _ = _walk(2, 5)
    js = JaxState(kname, d=D, window=WINDOW, lam=1.0 / D, noise=NOISE,
                  tol=1e-10)
    for x, g in obs[:2]:
        js.extend(jnp.asarray(x), jnp.asarray(g))
    arrays = {k: None if v is None else np.asarray(v)
              for k, v in js.data._asdict().items()}
    ts = convert.state_from_numpy(arrays, kernel=kname, window=WINDOW,
                                  noise=NOISE, tol=1e-10, device="cpu",
                                  dtype=torch.float64)
    _assert_same(js, ts)
    for x, g in obs[2:]:
        js.extend(jnp.asarray(x), jnp.asarray(g))
        ts.extend(torch.tensor(x), torch.tensor(g))
        _assert_same(js, ts)
    back = convert.data_to_numpy(ts.data)
    for k, v in js.data._asdict().items():
        if v is not None:
            assert np.asarray(back[k]).shape == np.asarray(v).shape, k


def test_convert_round_trip_is_exact():
    obs, _ = _walk(3, 3)
    _, ts = _states("rbf")
    for x, g in obs:
        ts.extend(torch.tensor(x), torch.tensor(g))
    again = convert.data_from_numpy(convert.data_to_numpy(ts.data),
                                    device="cpu", dtype=torch.float64)
    for k, v in ts.data._asdict().items():
        w = getattr(again, k)
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, w), k
        else:
            assert v == w, k


def test_window_none_grows_like_jax():
    """Capacity 2, no window: the third observation doubles it."""
    obs, x_last = _walk(4, 3)
    js = JaxState("rbf", d=D, capacity=2, lam=1.0 / D, noise=NOISE,
                  tol=1e-10)
    ts = GPGState("rbf", d=D, capacity=2, lam=1.0 / D, noise=NOISE, tol=1e-10,
                  dtype=torch.float64, device="cpu")
    for x, g in obs:
        js.extend(jnp.asarray(x), jnp.asarray(g))
        ts.extend(torch.tensor(x), torch.tensor(g))
        assert ts.data.capacity == js.data.capacity
        _assert_same(js, ts)
    assert ts.data.capacity == 4
    Xq = x_last[None] + 0.1 * np.random.RandomState(5).randn(3, D)
    pj, pt = js.posterior(jnp.asarray(Xq)), ts.posterior(torch.tensor(Xq))
    assert _rel(pt.grad.numpy(), pj.grad) <= TOL
    assert _rel(pt.value.numpy(), pj.value) <= TOL


@pytest.mark.parametrize("kname", ["matern52", "poly2"])
def test_explicit_evict_and_resolve_match_jax(kname):
    obs, _ = _walk(6, 4)
    js, ts = _states(kname)
    for x, g in obs:
        js.extend(jnp.asarray(x), jnp.asarray(g))
        ts.extend(torch.tensor(x), torch.tensor(g))
    js.evict(2)
    ts.evict(2)
    _assert_same(js, ts)
    rhs = np.random.RandomState(7).randn(2, D) / D
    zj = js.resolve(jnp.asarray(rhs))
    zt = ts.resolve(torch.tensor(rhs))
    assert _rel(zt.numpy(), zj) <= TOL
    _assert_same(js, ts)


def test_chol_rank1_update_matches_jax():
    rs = np.random.RandomState(8)
    A = rs.randn(6, 6)
    L = np.linalg.cholesky(A @ A.T + 6 * np.eye(6))
    v = rs.randn(6)
    want = jstate._chol_rank1_update(jnp.asarray(L), jnp.asarray(v))
    got = state._chol_rank1_update(torch.tensor(L), torch.tensor(v))
    assert _rel(got.numpy(), want) <= 1e-12
    assert _rel(got.numpy() @ got.numpy().T, L @ L.T + np.outer(v, v)) \
        <= 1e-12


def test_cg_matches_jax():
    rs = np.random.RandomState(9)
    A = rs.randn(12, 12)
    A = A @ A.T + 3 * np.eye(12)
    b = rs.randn(12)
    Pinv = np.diag(1.0 / np.diag(A))
    rj = jsolvers.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=1e-12,
                     maxiter=50, M_inv=lambda v: jnp.asarray(Pinv) @ v)
    At, Pt = torch.tensor(A), torch.tensor(Pinv)
    rt = solvers.cg(lambda v: At @ v, torch.tensor(b), tol=1e-12, maxiter=50,
                    M_inv=lambda v: Pt @ v)
    assert rt.iters == int(rj.iters)
    assert _rel(rt.x.numpy(), rj.x) <= 1e-10
    assert rt.resnorm <= 1e-12 * np.linalg.norm(b)


def test_default_maxiter_matches_jax():
    _, ts = _states("rbf")
    js, _ = _states("rbf")
    for cond in (None, 0.5, 10.0, 1e6, float("inf")):
        assert state._default_maxiter(ts.data, None, cond=cond) == \
            jstate._default_maxiter(js.data, None, cond=cond)
    assert state._default_maxiter(ts.data, 7) == 7


@pytest.mark.parametrize("call", [
    lambda: GPGState("rbf", d=4, precision="bf16", device="cpu"),
    lambda: GPGState("rbf", d=4, policy="compress", device="cpu"),
    lambda: GPGState("rbf", d=4, device="cpu").set_precision("bf16"),
    lambda: GPGState("rbf", d=4, device="cpu").refit(),
    lambda: GPGState("rbf", d=4, device="cpu").mll(),
    lambda: GPGState("rbf", d=4, device="cpu").posterior(
        torch.zeros(1, 4), return_std=True),
    lambda: build_gp_serve_step(GPGState("rbf", d=4, device="cpu"),
                                return_std=True, device="cpu"),
], ids=["bf16", "policy", "set_precision", "refit", "mll", "std",
        "serve_std"])
def test_later_slices_raise_not_implemented(call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call()


def test_serve_step_device_must_match_state():
    st = GPGState("rbf", d=4, device="cpu")
    with pytest.raises(ValueError):
        build_gp_serve_step(st, device="meta")
