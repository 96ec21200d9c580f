"""The port's batch-inference slice against the JAX package, at float64.

The same numpy inputs (a seeded random walk of N = 5 points in D = 300
with the gradients of the README's test function f(x) = sum(sin(x) *
roll(x, 1)) / D) go through ``repro.core`` (jnp backend, x64)
and ``repro_torch`` on the CPU (the plain versions, float64): factors,
the exact Woodbury and poly2 solves, CG with one and with stacked
right-hand sides, the cross matvecs, the posterior Hessian, the optimum
and both optimizer directions, bulk conditioning and Hessian-probe
queries. Both sides run the same algebra in another summation order, so
1e-8 relative (in norm) is far above what separates them on these
well-conditioned inputs. The Gram carries a noise of 1e-6: without it
the uncentred poly2 Gram is singular (x_b.g_a = x_a.g_b for every
quadratic), and so is any solve on it.

The walk lies on a grid of 1/8 and lam is 2^-8, so every pairwise r of
the data is exact on both sides. Otherwise the diagonal r_aa = |x_a|^2 +
|x_a|^2 - 2 x_a.x_a is roundoff of either sign, and the Matern kernels'
k''(r), which grows like r^-1/2 near 0, turns two summation orders'
roundoff into 1e-8-sized differences of K2e.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPGState as JaxState
from repro.core import build_factor_bundle as jax_bundle
from repro.core import build_factors as jax_build_factors
from repro.core import get_kernel as jax_kernel
from repro.core import gram as jgram
from repro.core import inference as jinf
from repro.core import mvm as jmvm
from repro.core import solvers as jsolvers
from repro.core import state as jstate
from repro.core import woodbury as jwood
from repro.optim import gp_directions as jdir
from repro.train.serve import build_gp_serve_step as jax_serve_step
from repro_torch import GPGState, build_gp_serve_step, convert, get_kernel
from repro_torch.core import gram, inference, mvm, solvers, state, woodbury
from repro_torch.optim import gp_directions as tdir

D = 300
N = 5
LAM = 2.0 ** -8
NOISE = 1e-6
TOL = 1e-8
KERNELS = ["rbf", "matern52", "poly2", "expdot"]


def _grad_f(x):
    return (np.cos(x) * np.roll(x, 1) + np.roll(np.sin(x), -1)) / x.shape[-1]


def _walk(seed, n=N, d=D):
    """n points of a seeded random walk on the 1/8 grid, their gradients
    and the walk's next point."""
    rs = np.random.RandomState(seed)
    x = np.round(8 * rs.randn(d)) / 8
    X = []
    for _ in range(n):
        X.append(x.copy())
        x = x + np.round(8 * rs.randn(d)) / 8
    X = np.array(X)
    return X, _grad_f(X), x


def _queries(seed, x, q=4, d=D):
    return x[None] + 0.1 * np.random.RandomState(seed).randn(q, d)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(float(np.linalg.norm(want)), 1e-300))


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _both(kname, seed=0, noise=NOISE, c=None):
    """(JAX factors, port factors, X, G, next walk point) at lam = LAM."""
    X, G, x = _walk(seed)
    lam = LAM
    jf = jax_build_factors(jax_kernel(kname), _j(X), lam=lam,
                           c=None if c is None else _j(c), noise=noise)
    tf = gram.build_factors(get_kernel(kname), _t(X), lam=lam,
                            c=None if c is None else _t(c), noise=noise)
    return jf, tf, X, G, x


@pytest.mark.parametrize("kname", KERNELS)
def test_build_factors_and_bundle_match_jax(kname):
    c = np.full(D, 0.2) if kname == "poly2" else None
    jf, tf, X, G, _ = _both(kname, c=c)
    for k in ("K1e", "K2e", "Xt"):
        assert _rel(getattr(tf, k).numpy(), getattr(jf, k)) <= TOL, k
    jb = jax_bundle(jax_kernel(kname), _j(X), _j(G), lam=LAM,
                    c=None if c is None else _j(c))
    tb = gram.build_factor_bundle(get_kernel(kname), _t(X), _t(G), lam=LAM,
                                  c=None if c is None else _t(c))
    for k in ("K1e", "K2e", "Xt"):
        assert _rel(getattr(tb.factors, k).numpy(),
                    getattr(jb.factors, k)) <= TOL, k
    assert _rel(tb.S.numpy(), jb.S) <= TOL
    assert _rel(tb.C.numpy(), jb.C) <= TOL


@pytest.mark.parametrize("kname", ["rbf", "poly2"])
def test_dense_gram_matches_jax(kname):
    X, _, x = _walk(1, n=3, d=20)
    Xq = _queries(2, x, q=2, d=20)
    lam = np.random.RandomState(3).randint(1, 5, 20) / 64.0
    want = jgram.dense_gram(jax_kernel(kname), _j(X), lam=_j(lam),
                            noise=0.01)
    got = gram.dense_gram(get_kernel(kname), _t(X), lam=_t(lam), noise=0.01)
    assert got.shape == (60, 60) and _rel(got.numpy(), want) <= TOL
    want = jgram.dense_cross_gram(jax_kernel(kname), _j(Xq), _j(X),
                                  lam=_j(lam))
    got = gram.dense_cross_gram(get_kernel(kname), _t(Xq), _t(X),
                                lam=_t(lam))
    assert got.shape == (40, 60) and _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("stationary", [False, True])
def test_materialize_keeps_the_row_major_vec_convention(stationary):
    """One batched pass over the basis stack builds the JAX vmap's matrix:
    column k is the row-major vec of op(E_k)."""
    rs = np.random.RandomState(4)
    n = 4
    K1i, S, K2e = rs.randn(n, n), rs.randn(n, n), rs.randn(n, n) + 3.0
    if stationary:
        jop = lambda Q: -Q.T / _j(K2e) + jmvm.lt_op(
            _j(K1i) @ jmvm.l_op(Q) @ _j(S))
        top = lambda Q: -Q.transpose(-1, -2) / _t(K2e) + mvm.lt_op(
            _t(K1i) @ mvm.l_op(Q) @ _t(S))
    else:
        jop = lambda Q: Q.T / _j(K2e) + _j(K1i) @ Q @ _j(S)
        top = lambda Q: Q.transpose(-1, -2) / _t(K2e) + _t(K1i) @ Q @ _t(S)
    want = jwood._materialize(jop, n, jnp.float64)
    got = woodbury._materialize(top, n, _t(S))
    assert _rel(got.numpy(), want) <= 1e-14
    Q = rs.randn(n, n)
    assert _rel((got @ _t(Q).reshape(-1)).numpy(),
                top(_t(Q)).reshape(-1).numpy()) <= 1e-14


@pytest.mark.parametrize("kname", KERNELS)
def test_woodbury_solve_matches_jax(kname):
    jf, tf, X, G, _ = _both(kname)
    spec_j, spec_t = jax_kernel(kname), get_kernel(kname)
    want = jwood.woodbury_solve(spec_j, jf, _j(G))
    got = woodbury.woodbury_solve(spec_t, tf, _t(G))
    assert _rel(got.numpy(), want) <= TOL
    resid = mvm.gram_matvec(tf, got, stationary=spec_t.is_stationary)
    assert _rel(resid.numpy(), G) <= 1e-6
    tb = gram.build_factor_bundle(spec_t, _t(X), _t(G), lam=LAM,
                                  noise=NOISE)
    again = woodbury.woodbury_solve(spec_t, tb.factors, _t(G), bundle=tb)
    assert _rel(again.numpy(), want) <= TOL


def test_woodbury_solve_matches_the_dense_solve():
    X, G, _ = _walk(5, n=3, d=40)
    spec = get_kernel("matern52")
    f = gram.build_factors(spec, _t(X), lam=1.0 / 32)
    Z = woodbury.woodbury_solve(spec, f, _t(G))
    want = woodbury.dense_solve(spec, _t(X), _t(G), lam=1.0 / 32)
    assert _rel(Z.numpy(), want.numpy()) <= 1e-6
    jwant = jwood.dense_solve(jax_kernel("matern52"), _j(X), _j(G),
                              lam=1.0 / 32)
    assert _rel(want.numpy(), jwant) <= TOL


def test_woodbury_noise_needs_a_scalar_lam():
    X, G, _ = _walk(6, n=3, d=20)
    spec = get_kernel("rbf")
    f = gram.build_factors(spec, _t(X), lam=_t(np.full(20, 1 / 16)),
                           noise=1e-4)
    with pytest.raises(ValueError, match="scalar Lambda"):
        woodbury.woodbury_solve(spec, f, _t(G))


def test_poly2_quadratic_solve_matches_jax():
    rs = np.random.RandomState(7)
    A = np.exp(rs.uniform(np.log(0.5), np.log(100.0), D))
    x_star = rs.randn(D)
    X = np.round(8 * rs.randn(N, D)) / 8
    G = (X - x_star) * A
    g_c = -A * x_star
    lam = LAM
    jf = jax_build_factors(jax_kernel("poly2"), _j(X), lam=lam)
    tf = gram.build_factors(get_kernel("poly2"), _t(X), lam=lam)
    want = jwood.poly2_quadratic_solve(jf, _j(G), g_c=_j(g_c))
    got = woodbury.poly2_quadratic_solve(tf, _t(G), g_c=_t(g_c))
    assert _rel(got.numpy(), want) <= TOL
    # Z solves the (noise-free) Gram system on the residual G - g_c
    resid = mvm.gram_matvec(tf, got, stationary=False)
    assert _rel(resid.numpy(), G - g_c) <= 1e-6


@pytest.mark.parametrize("kname", KERNELS)
def test_gram_cg_solve_single_and_stacked_match_jax(kname):
    jf, tf, X, G, _ = _both(kname)
    rs = np.random.RandomState(8)
    Gs = np.stack([G] + [rs.randn(N, D) * np.linalg.norm(G) /
                         np.sqrt(N * D) for _ in range(2)])
    spec_j, spec_t = jax_kernel(kname), get_kernel(kname)
    rj = jsolvers.gram_cg_solve(spec_j, jf, _j(G), tol=1e-12, maxiter=200)
    rt = solvers.gram_cg_solve(spec_t, tf, _t(G), tol=1e-12, maxiter=200)
    assert rt.iters == int(rj.iters)
    assert _rel(rt.x.numpy(), rj.x) <= TOL
    mj = jsolvers.gram_cg_solve_multi(spec_j, jf, _j(Gs), tol=1e-12,
                                      maxiter=200)
    mt = solvers.gram_cg_solve_multi(spec_t, tf, _t(Gs), tol=1e-12,
                                     maxiter=200)
    assert mt.x.shape == (3, N, D) and mt.iters == int(mj.iters)
    assert _rel(mt.x.numpy(), mj.x) <= TOL
    # the stacked solve solves each system
    for r in range(3):
        resid = mvm.gram_matvec(tf, mt.x[r].contiguous(),
                                stationary=spec_t.is_stationary)
        assert _rel(resid.numpy(), Gs[r]) <= 1e-10


def test_gram_cg_solve_multi_takes_only_a_stack():
    _, tf, _, G, _ = _both("rbf")
    with pytest.raises(ValueError):
        solvers.gram_cg_solve_multi(get_kernel("rbf"), tf, _t(G))


@pytest.mark.parametrize("kname", KERNELS)
def test_cross_matvecs_and_posterior_means_match_jax(kname):
    c = np.full(D, -0.3) if kname == "expdot" else None
    jf, tf, X, G, x = _both(kname, c=c)
    spec_j, spec_t = jax_kernel(kname), get_kernel(kname)
    Z = jwood.woodbury_solve(spec_j, jf, _j(G))
    Zt = _t(np.asarray(Z))
    Xq = _queries(9, x)
    for jfn, tfn in ((jinf.posterior_grad, inference.posterior_grad),
                     (jinf.posterior_value, inference.posterior_value)):
        want = jfn(spec_j, _j(Xq), jf, Z)
        got = tfn(spec_t, _t(Xq), tf, Zt)
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= TOL
    V = np.random.RandomState(10).randn(N, D)
    want = jmvm.cross_grad_matvec(spec_j, _j(Xq), jf, _j(V), lam=LAM / 2)
    got = mvm.cross_grad_matvec(spec_t, _t(Xq), tf, _t(V), lam=LAM / 2)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("kname", KERNELS)
def test_posterior_hessian_matches_jax(kname):
    jf, tf, X, G, x = _both(kname)
    spec_j, spec_t = jax_kernel(kname), get_kernel(kname)
    Z = jwood.woodbury_solve(spec_j, jf, _j(G))
    xq = _queries(11, x, q=1)[0]
    Hj = jinf.posterior_hessian(spec_j, _j(xq), jf, Z)
    Ht = inference.posterior_hessian(spec_t, _t(xq), tf, _t(np.asarray(Z)))
    for k in ("P", "W", "diag"):
        assert _rel(getattr(Ht, k).numpy(), getattr(Hj, k)) <= TOL, k
    v = np.random.RandomState(12).randn(D)
    assert _rel(Ht.matvec(_t(v)).numpy(), Hj.matvec(_j(v))) <= TOL
    assert _rel(Ht.dense().numpy(), Hj.dense()) <= TOL
    assert _rel(Ht.solve(_t(v)).numpy(), Hj.solve(_j(v))) <= TOL


@pytest.mark.parametrize("kname", ["rbf", "poly2"])
def test_directions_and_optimum_match_jax(kname):
    X, G, x = _walk(13)
    x_t, lam = x, LAM
    g_t = _grad_f(x)
    want = jdir.gph_direction(_j(X), _j(G), _j(x_t), _j(g_t), kernel=kname,
                              lam=lam, noise=NOISE)
    got = tdir.gph_direction(_t(X), _t(G), _t(x_t), _t(g_t), kernel=kname,
                             lam=lam, noise=NOISE)
    assert _rel(got.numpy(), want) <= TOL
    lam_g = tdir.auto_lengthscale(_t(G))
    assert lam_g.ndim == 0
    assert _rel(lam_g.numpy(), jdir.auto_lengthscale(_j(G))) <= TOL
    want = jdir.gpx_direction(_j(X), _j(G), _j(x_t), kernel=kname,
                              lam=jdir.auto_lengthscale(_j(G)))
    got = tdir.gpx_direction(_t(X), _t(G), _t(x_t), kernel=kname, lam=lam_g)
    assert got.shape == (D,) and _rel(got.numpy(), want) <= TOL
    # infer_optimum at a non-zero gradient query
    spec_j, spec_t = jax_kernel(kname), get_kernel(kname)
    jf = jax_build_factors(spec_j, _j(G), lam=0.5)
    tf = gram.build_factors(spec_t, _t(G), lam=0.5)
    Z = jwood.woodbury_solve(spec_j, jf, _j(X - x_t))
    gq = 0.1 * g_t
    want = jinf.infer_optimum(spec_j, jf, Z, _j(x_t), g_query=_j(gq))
    got = inference.infer_optimum(spec_t, tf, _t(np.asarray(Z)), _t(x_t),
                                  g_query=_t(gq))
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("kname", KERNELS)
def test_from_data_and_refactor_match_jax(kname):
    X, G, x = _walk(14)
    kw = dict(window=8, lam=LAM, noise=NOISE, tol=1e-12)
    js = JaxState.from_data(kname, _j(X), _j(G), **kw)
    ts = GPGState.from_data(kname, _t(X), _t(G), dtype=torch.float64,
                            device="cpu", **kw)
    assert ts.n == N and ts.stats["n_refactor"] == 1
    for k in ("Z", "L", "K1e", "K2e", "Xt"):
        assert _rel(getattr(ts.data, k).numpy(),
                    getattr(js.data, k)) <= TOL, k
    js.refactor(lam=LAM / 2)
    ts.refactor(lam=LAM / 2)
    assert ts.stats["n_refactor"] == 2
    for k in ("Z", "L", "K1e"):
        assert _rel(getattr(ts.data, k).numpy(),
                    getattr(js.data, k)) <= TOL, k
    # streaming on from a bulk-conditioned state
    js.extend(_j(x), _j(_grad_f(x)))
    ts.extend(_t(x), _t(_grad_f(x)))
    assert _rel(ts.data.Z.numpy(), js.data.Z) <= TOL


def test_gpg_refactor_with_a_new_rhs_matches_jax():
    """The flipped GP-X pattern: refactor at a new Lambda and solve for
    another right-hand side in the same call."""
    X, G, x = _walk(20)
    kw = dict(window=8, lam=LAM, noise=NOISE, tol=1e-12)
    js = JaxState.from_data("rbf", _j(G), _j(X), **kw)
    ts = GPGState.from_data("rbf", _t(G), _t(X), dtype=torch.float64,
                            device="cpu", **kw)
    rhs = np.zeros((8, D))
    rhs[:N] = X - x
    jd = jstate.gpg_refactor(js.spec, js.data, LAM / 2, noise=NOISE,
                             tol=1e-12, rhs=_j(rhs))
    td = state.gpg_refactor(ts.spec, ts.data, LAM / 2, noise=NOISE,
                            tol=1e-12, rhs=_t(rhs))
    assert td.n_refactor == 2 and float(td.lam) == LAM / 2
    for k in ("Z", "L", "K1e"):
        assert _rel(getattr(td, k).numpy(), getattr(jd, k)) <= TOL, k


def test_from_data_refuses_more_rows_than_the_window():
    X, G, _ = _walk(15)
    with pytest.raises(ValueError, match="window"):
        GPGState.from_data("rbf", _t(X), _t(G), window=3, device="cpu",
                           dtype=torch.float64)


@pytest.mark.parametrize("kname", ["rbf", "poly2"])
def test_probe_queries_match_jax(kname):
    """The quickstart's call, st.posterior(Xq, probe=v), and the serve
    step with a probe over a ragged microbatch split."""
    X, G, x = _walk(16)
    kw = dict(window=6, lam=LAM, noise=NOISE, tol=1e-12)
    js = JaxState.from_data(kname, _j(X), _j(G), **kw)
    ts = GPGState.from_data(kname, _t(X), _t(G), dtype=torch.float64,
                            device="cpu", **kw)
    Xq = _queries(17, x, q=5)
    v = np.random.RandomState(18).randn(D)
    pj = js.posterior(_j(Xq[:2]), probe=_j(v))
    pt = ts.posterior(_t(Xq[:2]), probe=_t(v))
    assert pt.hess_v.shape == (2, D)
    for k in ("value", "grad", "hess_v"):
        assert _rel(getattr(pt, k).numpy(), getattr(pj, k)) <= TOL, k
    sj = jax_serve_step(js, microbatch=2, probe=_j(v)).query(_j(Xq))
    st = build_gp_serve_step(ts, microbatch=2, probe=_t(v),
                             device="cpu").query(_t(Xq))
    assert st.hess_v.shape == (5, D)
    for k in ("value", "grad", "hess_v"):
        assert _rel(getattr(st, k).numpy(), getattr(sj, k)) <= TOL, k


def test_state_directions_match_jax():
    X, G, x = _walk(19)
    g_t = _grad_f(x)
    kw = dict(window=8, lam=LAM, noise=NOISE, tol=1e-12)
    js = JaxState.from_data("rbf", _j(X), _j(G), **kw)
    ts = GPGState.from_data("rbf", _t(X), _t(G), dtype=torch.float64,
                            device="cpu", **kw)
    want = jdir.gph_direction_state(js, _j(x), _j(g_t))
    got = tdir.gph_direction_state(ts, _t(x), _t(g_t))
    assert _rel(got.numpy(), want) <= TOL
    jg = JaxState.from_data("rbf", _j(G), _j(X), **kw)
    tg = GPGState.from_data("rbf", _t(G), _t(X), dtype=torch.float64,
                            device="cpu", **kw)
    want = jdir.gpx_direction_state(jg, _j(x))
    got = tdir.gpx_direction_state(tg, _t(x))
    assert _rel(got.numpy(), want) <= TOL


def test_factors_convert_round_trip_and_woodbury_from_jax_factors():
    jf, _, X, G, _ = _both("matern52")
    arrays = {k: None if v is None else np.asarray(v)
              for k, v in jf._asdict().items()}
    tf = convert.factors_from_numpy(arrays, device="cpu",
                                    dtype=torch.float64)
    back = convert.factors_to_numpy(tf)
    for k, v in arrays.items():
        if v is None:
            assert back[k] is None, k
        else:
            assert np.array_equal(np.asarray(back[k]), v), k
    want = jwood.woodbury_solve(jax_kernel("matern52"), jf, _j(G))
    got = woodbury.woodbury_solve(get_kernel("matern52"), tf, _t(G))
    assert _rel(got.numpy(), want) <= TOL
    with pytest.raises(ValueError, match="shift"):
        convert.factors_from_numpy(dict(arrays, shift=np.zeros(D)),
                                   device="cpu")
