"""On the card: each of the seven CUDA kernels of the port against its plain
version.

Every test here is marked ``gpu`` and skips without an sm_90 card. The
module imports neither JAX nor the JAX package, so the card's machine runs
it without them (README, "PyTorch/CUDA port"):

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \
        tests/test_torch_kernels_card.py

Tolerance: 1e-5 relative to the output's max-abs -- the kernels and the
plain versions sum the same f32 (or bf16-stored) values in another order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

F32_TOL = 1e-5


def _arr(seed, *shape):
    return np.random.RandomState(seed).randn(*shape)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) /
                 max(float(np.max(np.abs(want))), 1e-300))


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _card(seed, *shape, dtype=torch.float32):
    return torch.tensor(_arr(seed, *shape), dtype=torch.float32,
                        device="cuda").to(dtype)


def _factor(per_lane, seed, d):
    """A scalar 1/D, or a positive per-lane (D,) factor around it (the
    kernels' stride-1 route)."""
    if not per_lane:
        return torch.tensor(1.0 / d, device="cuda")
    rs = np.random.RandomState(seed)
    return torch.tensor((0.5 + rs.rand(d)) / d, dtype=torch.float32,
                        device="cuda")


LANES = pytest.mark.parametrize("per_lane", [False, True],
                                ids=["scalar", "per_lane"])


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_factor_build_kernel_on_card(sm90, dtype, per_lane):
    d = 100_003
    A, B = _card(1, 64, d, dtype=dtype), _card(2, 16, d, dtype=dtype)
    V = _card(3, 16, d)
    lam, vs = _factor(per_lane, 5, d), _factor(per_lane, 6, d)
    got = ops.fused_factor_build(A, B, V, lam, v_scale=vs)
    want = ref.fused_factor_build_ref(A, B, V, lam, vs)
    for g, w in zip(got, want):
        assert _rel(g.cpu().numpy(), w.cpu().numpy()) <= F32_TOL


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_update_kernel_on_card(sm90, dtype, per_lane):
    d = 100_003
    K1, M = _card(1, 64, 16), _card(2, 64, 16)
    V, X = _card(3, 16, d), _card(4, 16, d, dtype=dtype)
    if per_lane:
        lam, vs = _factor(True, 5, d), _factor(True, 6, d)
    else:
        lam, vs = 0.5, None
    got = ops.gram_update(K1, M, V, X, lam, v_scale=vs)
    want = ref.gram_update_ref(K1, M, V, X, lam, vs)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= F32_TOL


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("stationary", [False, True])
def test_fused_gram_mvm_kernel_on_card(sm90, stationary, per_lane):
    d = 100_003
    K1e, K2e = _card(1, 16, 16), _card(2, 16, 16)
    Xt, V = _card(3, 16, d), _card(4, 16, d)
    lam = _factor(per_lane, 5, d)
    got = ops.fused_gram_mvm(K1e, K2e, Xt, V, lam, stationary=stationary,
                             noise=1e-6)
    want = ref.fused_gram_mvm_ref(K1e, K2e, Xt, V, lam,
                                  stationary=stationary, noise=1e-6)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= F32_TOL


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("na,nb", [(64, 16), (16, 16), (1, 16)])
def test_skinny_gram_and_gram_norms_kernels_on_card(sm90, dtype, per_lane,
                                                    na, nb):
    """Includes the single zero-row query of infer_optimum (Na = 1) and
    the same tensor as A and B (build_factors(X, X))."""
    d = 100_003
    B = _card(2, nb, d, dtype=dtype)
    A = B if na == nb else _card(1, na, d, dtype=dtype)
    lam = _factor(per_lane, 5, d)
    got = ops.skinny_gram(A, B, lam)
    assert _rel(got.cpu().numpy(),
                ref.skinny_gram_ref(A, B, lam).cpu().numpy()) <= F32_TOL
    for g, w in zip(ops.fused_gram_norms(A, B, lam),
                    ref.fused_gram_norms_ref(A, B, lam)):
        assert g.shape == w.shape
        assert _rel(g.cpu().numpy(), w.cpu().numpy()) <= F32_TOL


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq", [16, 5])
def test_small_matmul_kernel_on_card(sm90, dtype, per_lane, nq):
    d = 100_003
    K, V = _card(1, nq, 16), _card(3, 16, d, dtype=dtype)
    scale = _factor(per_lane, 5, d) if per_lane else 3.0
    got = ops.small_matmul(K, V, scale)
    want = ref.small_matmul_ref(K, V, scale)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= F32_TOL


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("stationary", [False, True])
@pytest.mark.parametrize("r", [1, 4])
def test_fused_gram_mvm_multi_kernel_on_card(sm90, stationary, per_lane, r):
    """Each slab of the stacked product equals the single-RHS kernel's
    product of that slab."""
    d = 100_003
    K1e, K2e = _card(1, 16, 16), _card(2, 16, 16)
    Xt, V = _card(3, 16, d), _card(4, r, 16, d)
    lam = _factor(per_lane, 5, d)
    got = ops.fused_gram_mvm(K1e, K2e, Xt, V, lam, stationary=stationary,
                             noise=1e-6)
    want = ref.fused_gram_mvm_ref(K1e, K2e, Xt, V, lam,
                                  stationary=stationary, noise=1e-6)
    assert got.shape == (r, 16, d)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= F32_TOL
    one = ops.fused_gram_mvm(K1e, K2e, Xt, V[-1].contiguous(), lam,
                             stationary=stationary, noise=1e-6)
    assert _rel(got[-1].cpu().numpy(), one.cpu().numpy()) <= F32_TOL


@pytest.mark.gpu
def test_multi_rhs_past_the_shared_memory_budget_raises(sm90):
    n, d = 16, 1000
    K = torch.zeros(n, n, device=sm90)
    with pytest.raises(ValueError, match="not supported"):
        ops.fused_gram_mvm(K, K, torch.zeros(n, d, device=sm90),
                           torch.zeros(64, n, d, device=sm90), 1.0,
                           stationary=True)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 31, 32, 300, 16_385, 1_000_003, 4_194_304])
def test_split_plan_covers_d(sm90, d):
    """The split plan the libraries own: whole tiles, at most 512 CTAs,
    every column of D in exactly one slice."""
    from repro_torch.kernels import _build

    for name in _build.SPLIT:
        G, chunk = _build.split_plan(name, d)
        assert chunk % 32 == 0 and 1 <= G <= 512
        assert (G - 1) * chunk < d <= G * chunk


@pytest.mark.gpu
def test_kernels_raise_on_what_they_do_not_take(sm90):
    x64 = torch.zeros(4, 64, dtype=torch.float64, device=sm90)
    with pytest.raises(ValueError):
        ops.fused_factor_build(x64, x64, None, 1.0)
    strided = torch.zeros(64, 4, device=sm90).T
    with pytest.raises(ValueError):
        ops.fused_factor_build(strided, strided, None, 1.0)
    with pytest.raises(ValueError):
        ops.fused_gram_mvm(torch.zeros(4, 4, device=sm90),
                           torch.zeros(4, 4, dtype=torch.float64, device=sm90),
                           torch.zeros(4, 64, device=sm90),
                           torch.zeros(4, 64, device=sm90), 1.0,
                           stationary=True)
