"""The port's seven kernel wrappers against the JAX package.

Each kernel of the port (``repro_torch.kernels.ops``: fused_factor_build,
gram_update, fused_gram_mvm and its stacked-RHS form, skinny_gram,
fused_gram_norms, small_matmul) is held against its JAX counterpart on
the same numpy inputs, two ways:

  * the JAX jnp path (``repro.core.backend`` under ``use_backend("jnp")``,
    x64) against the port's plain version at float64: <= 1e-12 relative;
  * the JAX Pallas kernel in interpret mode (``repro.kernels.ops.*(...,
    interpret=True)``) against the port at f32 and with bf16-stored
    inputs: <= 1e-5 relative to the output's max-abs (both accumulate the
    same stored values in f32; the sums run in another order).

D = 300 is deliberately not a multiple of 128. The CUDA kernels are held
against their plain versions on the card in test_torch_kernels_card.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref

D = 300
X64_TOL = 1e-12
F32_TOL = 1e-5


def _arr(seed, *shape):
    return np.random.RandomState(seed).randn(*shape)


def _lam(kind, d=D, seed=7):
    if kind == "scalar":
        return 0.37
    return np.abs(_arr(seed, d)) + 0.1


def _jax(x, dtype=jnp.float64):
    return x if isinstance(x, float) else jnp.asarray(x, dtype)


def _torch(x, dtype=torch.float64):
    return x if isinstance(x, float) else torch.tensor(x).to(dtype)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) /
                 max(float(np.max(np.abs(want))), 1e-300))


def _stream_pair(x, bf16):
    """(jax array, torch tensor) holding the same stored values."""
    if bf16:
        return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    return jnp.asarray(x, jnp.float32), torch.tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# fused_factor_build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("na,nb", [(8, 4), (4, 1), (3, 7)])
@pytest.mark.parametrize("lam_kind", ["scalar", "vector"])
def test_fused_factor_build_matches_jnp_x64(na, nb, lam_kind):
    A, B, V = _arr(1, na, D), _arr(2, nb, D), _arr(3, nb, D)
    lam, vs = _lam(lam_kind), _lam(lam_kind, seed=8)
    with jbackend.use_backend("jnp"):
        want = jbackend.fused_factor_build(_jax(A), _jax(B), _jax(V),
                                           _jax(lam), v_scale=_jax(vs))
    got = ops.fused_factor_build(_torch(A), _torch(B), _torch(V),
                                 _torch(lam), v_scale=_torch(vs))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert tuple(g.shape) == w.shape
        assert _rel(g.numpy(), w) <= X64_TOL


@pytest.mark.parametrize("storage", ["f32", "bf16", "mixed"])
@pytest.mark.parametrize("lam_kind", ["scalar", "vector"])
def test_fused_factor_build_matches_pallas_interpret(storage, lam_kind):
    """"mixed" is the bf16 query path: bf16 data streams, f32 Z."""
    A, B, V = _arr(1, 8, D), _arr(2, 5, D), _arr(3, 5, D)
    lam, vs = _lam(lam_kind), _lam(lam_kind, seed=8)
    bf16 = storage != "f32"
    (Aj, At), (Bj, Bt) = (_stream_pair(x, bf16) for x in (A, B))
    Vj, Vt = _stream_pair(V, storage == "bf16")
    want = jops.fused_factor_build(Aj, Bj, Vj, _jax(lam, jnp.float32),
                                   v_scale=_jax(vs, jnp.float32),
                                   interpret=True)
    got = ops.fused_factor_build(At, Bt, Vt, _torch(lam, torch.float32),
                                 v_scale=_torch(vs, torch.float32))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= F32_TOL


def test_fused_factor_build_reuses_b_for_v():
    A, B = torch.tensor(_arr(1, 3, D)), torch.tensor(_arr(2, 2, D))
    for g, w in zip(ops.fused_factor_build(A, B, None, 0.5),
                    ops.fused_factor_build(A, B, B, 0.5)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# gram_update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,n,noise", [(6, 4, 0.0), (5, 5, 0.3)])
@pytest.mark.parametrize("lam_kind", ["scalar", "vector"])
@pytest.mark.parametrize("with_vs", [False, True])
def test_gram_update_matches_jnp_x64(nq, n, noise, lam_kind, with_vs):
    K1, M = _arr(1, nq, n), _arr(2, nq, n)
    V, X = _arr(3, n, D), _arr(4, n, D)
    lam = _lam(lam_kind)
    vs = _lam("vector", seed=9) if with_vs else None
    with jbackend.use_backend("jnp"):
        want = jbackend.gram_update(_jax(K1), _jax(M), _jax(V), _jax(X),
                                    _jax(lam),
                                    v_scale=None if vs is None else _jax(vs),
                                    noise=noise)
    got = ops.gram_update(_torch(K1), _torch(M), _torch(V), _torch(X),
                          _torch(lam),
                          v_scale=None if vs is None else _torch(vs),
                          noise=noise)
    assert got.dtype == torch.float64 and tuple(got.shape) == (nq, D)
    assert _rel(got.numpy(), want) <= X64_TOL


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("noise", [0.0, 0.25])
def test_gram_update_matches_pallas_interpret(bf16, noise):
    n = 6
    nq = n if noise else 8
    K1 = _arr(1, nq, n).astype(np.float32)
    M = _arr(2, nq, n).astype(np.float32)
    (Vj, Vt), (Xj, Xt) = (_stream_pair(_arr(s, n, D), bf16) for s in (3, 4))
    lam, vs = _lam("vector"), _lam("vector", seed=9)
    want = jops.gram_update(jnp.asarray(K1), jnp.asarray(M), Vj, Xj,
                            _jax(lam, jnp.float32),
                            v_scale=_jax(vs, jnp.float32), noise=noise,
                            interpret=True)
    got = ops.gram_update(torch.tensor(K1), torch.tensor(M), Vt, Xt,
                          _torch(lam, torch.float32),
                          v_scale=_torch(vs, torch.float32), noise=noise)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= F32_TOL


# ---------------------------------------------------------------------------
# fused_gram_mvm and the Alg.-2 small algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stationary", [False, True])
@pytest.mark.parametrize("lam_kind", ["scalar", "vector"])
def test_fused_gram_mvm_matches_jnp_x64(stationary, lam_kind):
    n = 6
    K1e, K2e = _arr(1, n, n), _arr(2, n, n)
    Xt, V = _arr(3, n, D), _arr(4, n, D)
    lam = _lam(lam_kind)
    noise = 0.01 if lam_kind == "scalar" else 0.0
    with jbackend.use_backend("jnp"):
        want = jbackend.fused_gram_mvm(_jax(K1e), _jax(K2e), _jax(Xt),
                                       _jax(V), _jax(lam),
                                       stationary=stationary, noise=noise)
    got = ops.fused_gram_mvm(_torch(K1e), _torch(K2e), _torch(Xt), _torch(V),
                             _torch(lam), stationary=stationary, noise=noise)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= X64_TOL


@pytest.mark.parametrize("stationary", [False, True])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_gram_mvm_matches_pallas_interpret(stationary, bf16):
    n = 5
    K1e = _arr(1, n, n).astype(np.float32)
    K2e = _arr(2, n, n).astype(np.float32)
    (Xj, Xt), (Vj, Vt) = (_stream_pair(_arr(s, n, D), bf16) for s in (3, 4))
    lam = 0.37
    want = jops.fused_gram_mvm(jnp.asarray(K1e), jnp.asarray(K2e), Xj, Vj,
                               lam, stationary=stationary, noise=1e-3,
                               interpret=True)
    got = ops.fused_gram_mvm(torch.tensor(K1e), torch.tensor(K2e), Xt, Vt,
                             lam, stationary=stationary, noise=1e-3)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= F32_TOL


@pytest.mark.parametrize("stationary", [False, True])
def test_small_op_matches_jax(stationary):
    K2e, M = _arr(1, 7, 7), _arr(2, 7, 7)
    want = jref.small_op(jnp.asarray(K2e), jnp.asarray(M),
                         stationary=stationary)
    got = ref.small_op(torch.tensor(K2e), torch.tensor(M),
                       stationary=stationary)
    assert _rel(got.numpy(), want) <= X64_TOL


# ---------------------------------------------------------------------------
# skinny_gram and fused_gram_norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("na,nb", [(8, 4), (1, 7), (3, 3)])
@pytest.mark.parametrize("lam_kind", ["scalar", "vector"])
def test_skinny_gram_and_gram_norms_match_jnp_x64(na, nb, lam_kind):
    """(1, 7) is infer_optimum's single zero-row query."""
    A, B = _arr(1, na, D), _arr(2, nb, D)
    lam = _lam(lam_kind)
    with jbackend.use_backend("jnp"):
        want_p = jbackend.scaled_gram(_jax(A), _jax(B), _jax(lam))
        want_n = jbackend.gram_norms(_jax(A), _jax(B), _jax(lam))
    got_p = ops.skinny_gram(_torch(A), _torch(B), _torch(lam))
    assert got_p.dtype == torch.float64 and tuple(got_p.shape) == (na, nb)
    assert _rel(got_p.numpy(), want_p) <= X64_TOL
    got_n = ops.fused_gram_norms(_torch(A), _torch(B), _torch(lam))
    for g, w in zip(got_n, want_n):
        assert tuple(g.shape) == w.shape
        assert _rel(g.numpy(), w) <= X64_TOL


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("lam_kind", ["scalar", "vector"])
def test_skinny_gram_and_gram_norms_match_pallas_interpret(bf16, lam_kind):
    (Aj, At), (Bj, Bt) = (_stream_pair(_arr(s, n, D), bf16)
                          for s, n in ((1, 7), (2, 5)))
    lam = _lam(lam_kind)
    want = jops.skinny_gram(Aj, Bj, _jax(lam, jnp.float32), interpret=True)
    got = ops.skinny_gram(At, Bt, _torch(lam, torch.float32))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= F32_TOL
    want = jops.fused_gram_norms(Aj, Bj, _jax(lam, jnp.float32),
                                 interpret=True)
    got = ops.fused_gram_norms(At, Bt, _torch(lam, torch.float32))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= F32_TOL


@pytest.mark.parametrize("lam_kind", ["scalar", "vector"])
def test_one_tensor_as_a_and_b_matches_jax_ref(lam_kind):
    """The bundle sweep's fused_factor_build(X, X, G) and from_data's
    fused_gram_norms(X, X): one tensor as A and B, as the card's symmetric
    mode takes it, against the JAX package's plain kernels (f32 sums on
    both sides)."""
    (Xj, Xt), (Gj, Gt) = (_stream_pair(_arr(s, 6, D), False) for s in (1, 2))
    lam = _lam(lam_kind)
    pairs = ((ops.fused_factor_build(Xt, Xt, Gt, _torch(lam, torch.float32)),
              jref.fused_factor_build_ref(Xj, Xj, Gj, _jax(lam, jnp.float32))),
             (ops.fused_gram_norms(Xt, Xt, _torch(lam, torch.float32)),
              jref.fused_gram_norms_ref(Xj, Xj, _jax(lam, jnp.float32))))
    for got, want in pairs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            w = np.asarray(w).reshape(tuple(g.shape))
            assert _rel(g.numpy(), w) <= F32_TOL


# ---------------------------------------------------------------------------
# small_matmul (the Kronecker preconditioner) and the stacked Gram MVM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lam_kind", ["scalar", "vector"])
@pytest.mark.parametrize("stacked", [False, True])
def test_kron_precond_matches_jnp_x64(lam_kind, stacked):
    """The 2-D route is the small_matmul kernel's plain version; the
    stacked route is a plain product in both packages."""
    from repro_torch.core import backend as tbackend

    K = _arr(1, 6, 6)
    V = _arr(2, 3, 6, D) if stacked else _arr(2, 6, D)
    lam = _lam(lam_kind)
    with jbackend.use_backend("jnp"):
        want = jbackend.kron_precond(_jax(K), _jax(V), _jax(lam))
    got = tbackend.kron_precond(_torch(K), _torch(V), _torch(lam))
    assert got.dtype == torch.float64 and tuple(got.shape) == V.shape
    assert _rel(got.numpy(), want) <= X64_TOL


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_small_matmul_matches_pallas_interpret(bf16):
    K = _arr(1, 7, 5).astype(np.float32)
    Vj, Vt = _stream_pair(_arr(2, 5, D), bf16)
    scale = _lam("vector")
    want = jops.small_matmul(jnp.asarray(K), Vj, _jax(scale, jnp.float32),
                             interpret=True)
    got = ops.small_matmul(torch.tensor(K), Vt, _torch(scale, torch.float32))
    assert got.dtype == torch.float32 and tuple(got.shape) == (7, D)
    assert _rel(got.numpy(), want) <= F32_TOL


@pytest.mark.parametrize("stationary", [False, True])
@pytest.mark.parametrize("lam_kind", ["scalar", "vector"])
def test_fused_gram_mvm_multi_matches_jnp_x64(stationary, lam_kind):
    n, r = 6, 3
    K1e, K2e = _arr(1, n, n), _arr(2, n, n)
    Xt, V = _arr(3, n, D), _arr(4, r, n, D)
    lam = _lam(lam_kind)
    noise = 0.01 if lam_kind == "scalar" else 0.0
    with jbackend.use_backend("jnp"):
        want = jbackend.fused_gram_mvm(_jax(K1e), _jax(K2e), _jax(Xt),
                                       _jax(V), _jax(lam),
                                       stationary=stationary, noise=noise)
    ops.reset_launches()
    got = ops.fused_gram_mvm(_torch(K1e), _torch(K2e), _torch(Xt),
                             _torch(V), _torch(lam), stationary=stationary,
                             noise=noise)
    assert got.dtype == torch.float64 and tuple(got.shape) == (r, n, D)
    assert _rel(got.numpy(), want) <= X64_TOL
    assert all(v == 0 for v in ops.launches.values())


@pytest.mark.parametrize("stationary", [False, True])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_gram_mvm_multi_matches_pallas_interpret(stationary, bf16):
    n, r = 5, 3
    K1e = _arr(1, n, n).astype(np.float32)
    K2e = _arr(2, n, n).astype(np.float32)
    Xj, Xt = _stream_pair(_arr(3, n, D), bf16)
    Vj, Vt = _stream_pair(_arr(4, r, n, D), bf16)
    want = jops.fused_gram_mvm(jnp.asarray(K1e), jnp.asarray(K2e), Xj, Vj,
                               0.37, stationary=stationary, noise=1e-3,
                               interpret=True)
    got = ops.fused_gram_mvm(torch.tensor(K1e), torch.tensor(K2e), Xt, Vt,
                             0.37, stationary=stationary, noise=1e-3)
    assert got.dtype == torch.float32 and tuple(got.shape) == (r, n, D)
    assert _rel(got.numpy(), want) <= F32_TOL


# ---------------------------------------------------------------------------
# Wrapper contracts (CPU side)
# ---------------------------------------------------------------------------

def test_wrappers_raise_on_bad_shapes_and_devices():
    A, B = torch.zeros(3, D), torch.zeros(2, D)
    with pytest.raises(ValueError):
        ops.fused_factor_build(A, B, torch.zeros(3, D), 1.0)
    with pytest.raises(ValueError):
        ops.fused_factor_build(A, torch.zeros(2, D + 1), None, 1.0)
    with pytest.raises(ValueError):
        ops.gram_update(torch.zeros(4, 2), torch.zeros(4, 2), B, B, 1.0,
                        noise=0.1)
    with pytest.raises(ValueError):
        ops.fused_gram_mvm(torch.zeros(3, 3), torch.zeros(3, 3),
                           torch.zeros(3, D), torch.zeros(3, D, 2), 1.0,
                           stationary=True)
    with pytest.raises(ValueError):
        ops.fused_factor_build(torch.zeros(3, 0), torch.zeros(2, 0), None,
                               1.0)
    with pytest.raises(ValueError):
        ops.gram_update(torch.zeros(4, 2), torch.zeros(4, 2), B,
                        torch.zeros(D, 2).T, 1.0)  # not contiguous
    meta = torch.zeros(3, D, device="meta")
    with pytest.raises(ValueError):
        ops.fused_factor_build(meta, meta, None, 1.0)
    with pytest.raises(ValueError):
        ops.skinny_gram(A, torch.zeros(2, D + 1), 1.0)
    with pytest.raises(ValueError):
        ops.fused_gram_norms(A, torch.zeros(D, 2).T, 1.0)  # not contiguous
    with pytest.raises(ValueError):
        ops.small_matmul(torch.zeros(4, 3), B, 1.0)  # K (4, 3), V (2, D)
    with pytest.raises(ValueError):  # stacked V with another row count
        ops.fused_gram_mvm(torch.zeros(3, 3), torch.zeros(3, 3),
                           torch.zeros(3, D), torch.zeros(2, 4, D), 1.0,
                           stationary=False)


def test_cpu_route_counts_no_launch():
    ops.reset_launches()
    calls = dict(ref.cuda_calls)
    A = torch.tensor(_arr(1, 3, D))
    ops.fused_factor_build(A, A, None, 0.5)
    ops.gram_update(torch.eye(3, dtype=torch.float64),
                    torch.eye(3, dtype=torch.float64), A, A, 0.5)
    ops.fused_gram_mvm(torch.eye(3, dtype=torch.float64),
                       torch.eye(3, dtype=torch.float64), A, A, 0.5,
                       stationary=False)
    ops.skinny_gram(A, A, 0.5)
    ops.fused_gram_norms(A, A, 0.5)
    ops.small_matmul(torch.eye(3, dtype=torch.float64), A, 2.0)
    assert all(v == 0 for v in ops.launches.values())
    assert ref.cuda_calls == calls


def test_gram_mvm_phases_are_card_launches():
    """The Gram MVM's launches, apart for timing, exist only on the card;
    on the CPU the helper refuses rather than run the plain version."""
    A = torch.tensor(_arr(1, 3, D))
    eye = torch.eye(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="on the card"):
        ops.fused_gram_mvm_phases(eye, eye, A, A, 0.5, stationary=True)
    with pytest.raises(ValueError):  # the same shape checks as the product
        ops.fused_gram_mvm_phases(eye, eye, A, torch.zeros(2, D), 0.5,
                                  stationary=True)


def _c_params(src: str, entry: str) -> list[str]:
    """The parameter list of the exported C function ``entry`` in src."""
    start = src.index(f"RT_EXPORT int {entry}(") + len(f"RT_EXPORT int {entry}(")
    return [p.strip() for p in src[start:src.index(")", start)].split(",")]


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signatures_match_the_c_entry_points(name):
    """ctypes passes each argument as the type _build declares: a count or
    kind that differs from the C declaration would pass garbage on the
    card, where nothing checks it."""
    entry, argtypes = _build.SIGNATURES[name]
    params = _c_params((_build.CSRC / f"{name}.cu").read_text(), entry)
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        if "*" in p:
            assert t is _build._P, p
        elif p.startswith("long long"):
            assert t is _build._LL, p
        elif p.startswith("float"):
            assert t is _build._F, p
        else:
            assert p.startswith("int") and t is _build._I, p
