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
    """The split plan each library owns: every column of D in exactly one
    slice. splitk.cuh's plan cuts whole 32-column tiles into at most 512
    slices; the pipelined stage's (skinny_gram, the Gram MVMs) cuts whole
    256-column quanta into at most one slice per SM of this card."""
    from repro_torch.kernels import _build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in _build.SPLIT:
        G, chunk = _build.split_plan(name, d)
        assert (G - 1) * chunk < d <= G * chunk
        if name in _build.STAGE:
            assert chunk % 256 == 0 and 1 <= G <= sms
        else:
            assert chunk % 32 == 0 and 1 <= G <= 512


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
    # The pipelined first stage refuses exactly where no ring of three
    # stages fits the shared memory: beside 64 rows of A, the widest B it
    # takes works and one row more raises. splitk.cuh's P-only staging
    # took at most 235 rows of B there; the new stage takes at least those.
    from repro_torch.kernels import _build

    nb = max(k for k in range(1, 1024)
             if _build.stage_ring("skinny_gram", 0, 0, 64, k) > 0)
    assert nb >= 235
    assert _build.stage_ring("skinny_gram", 0, 0, 64, nb + 1) < 0
    gen = torch.Generator(device="cuda").manual_seed(9)
    A = _rnd(gen, 64, 1000)
    B = _rnd(gen, nb, 1000)
    assert _rel(ops.skinny_gram(A, B, 0.5).cpu().numpy(),
                ref.skinny_gram_ref(A, B, 0.5).cpu().numpy()) <= F32_TOL
    with pytest.raises(ValueError, match="not supported"):
        ops.skinny_gram(A, _rnd(gen, nb + 1, 1000), 0.5)


# ---------------------------------------------------------------------------
# The pipelined first stage (csrc/skinny_stage.cuh) behind skinny_gram and
# the Gram MVMs, at the widths where its tiles, vectors and ring wrap.
# ---------------------------------------------------------------------------

# "ring-1" / "ring+1": D = (SMs x one ring's columns) -/+ 1, where each
# CTA's slice is one ring length and the last tile is ragged, or the ring
# wraps once more. The other widths cut a 16-byte vector, a 128-column
# tile and a row start (D not a multiple of 8) in every way.
STAGE_DS = [1, 31, 127, 128, 129, "ring-1", "ring+1", 16_385, 1_000_003]
CODES = {torch.float32: 0, torch.bfloat16: 1}


def _rnd(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _stage_d(d, lib, a_dtype, b_dtype, na, nb, per_lane):
    if not isinstance(d, str):
        return d
    from repro_torch.kernels import _build

    ring = _build.stage_ring(lib, CODES[a_dtype], CODES[b_dtype], na, nb,
                             vec_lam=per_lane)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ring + (1 if d == "ring+1" else -1)


def _stage_lam(gen, per_lane, d):
    if not per_lane:
        return torch.tensor(1.0 / d, device="cuda")
    return (0.5 + torch.rand(d, generator=gen, device="cuda")) / d


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("na", [1, 5, 16, 64])
@pytest.mark.parametrize("d", STAGE_DS)
def test_skinny_gram_stage_widths_on_card(sm90, d, na, dtype, per_lane):
    nb = 16
    d = _stage_d(d, "skinny_gram", dtype, dtype, na, nb, per_lane)
    gen = torch.Generator(device="cuda").manual_seed(na)
    A, B = _rnd(gen, na, d, dtype=dtype), _rnd(gen, nb, d, dtype=dtype)
    lam = _stage_lam(gen, per_lane, d)
    got = ops.skinny_gram(A, B, lam)
    assert got.shape == (na, nb)
    assert _rel(got.cpu().numpy(),
                ref.skinny_gram_ref(A, B, lam).cpu().numpy()) <= F32_TOL


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,r", [(1, 1), (5, 1), (16, 1), (64, 1), (1, 4),
                                 (5, 4), (16, 4)])
@pytest.mark.parametrize("d", STAGE_DS)
def test_gram_mvm_stage_widths_on_card(sm90, d, n, r, dtype, per_lane):
    """B3 (R = 1) and B7 (R = 4) with Xt and V stored in ``dtype``; the
    stationary fold for f32 streams and the dot fold for bf16 ones."""
    d = _stage_d(d, "fused_gram_mvm", dtype, dtype, n, r * n, per_lane)
    stationary = dtype == torch.float32
    gen = torch.Generator(device="cuda").manual_seed(n * 10 + r)
    K1e, K2e = _rnd(gen, n, n), _rnd(gen, n, n)
    Xt = _rnd(gen, n, d, dtype=dtype)
    V = _rnd(gen, *((r, n, d) if r > 1 else (n, d)), dtype=dtype)
    lam = _stage_lam(gen, per_lane, d)
    got = ops.fused_gram_mvm(K1e, K2e, Xt, V, lam, stationary=stationary,
                             noise=1e-6)
    want = ref.fused_gram_mvm_ref(K1e, K2e, Xt, V, lam,
                                  stationary=stationary, noise=1e-6)
    assert got.shape == V.shape
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= F32_TOL


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(16, 1_000_003), (5, 129), (64, 16_385),
                                 (1, 31)])
def test_skinny_gram_symmetric_mode_on_card(sm90, n, d, dtype, per_lane):
    """skinny_gram(X, X) reads X once: against the two-tensor route on a
    copy of X and against the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(n)
    X = _rnd(gen, n, d, dtype=dtype)
    lam = _stage_lam(gen, per_lane, d)
    got = ops.skinny_gram(X, X, lam).cpu().numpy()
    assert _rel(got, ops.skinny_gram(X, X.clone(), lam).cpu().numpy()
                ) <= F32_TOL
    assert _rel(got, ref.skinny_gram_ref(X, X, lam).cpu().numpy()) <= F32_TOL


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_kernels_bitwise_repeatable_on_card(sm90, dtype, per_lane):
    """Two launches on the same inputs give the same bits (no atomics)."""
    d = 1_000_003
    gen = torch.Generator(device="cuda").manual_seed(3)
    A, B = _rnd(gen, 64, d, dtype=dtype), _rnd(gen, 16, d, dtype=dtype)
    K1e, K2e = _rnd(gen, 16, 16), _rnd(gen, 16, 16)
    V = _rnd(gen, 4, 16, d)
    lam = _stage_lam(gen, per_lane, d)
    calls = (lambda: ops.skinny_gram(A, B, lam),
             lambda: ops.skinny_gram(B, B, lam),
             lambda: ops.fused_gram_mvm(K1e, K2e, B, V[0], lam,
                                        stationary=True),
             lambda: ops.fused_gram_mvm(K1e, K2e, B, V, lam,
                                        stationary=False))
    for call in calls:
        assert torch.equal(call(), call())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1_000_003, 4_194_304])
def test_skinny_gram_against_float64_on_card(sm90, d, dtype):
    """The stage's sums against float64 sums of the same stored values
    (scalar lam = 1/D), at the query shape and with A = B: within 1e-6 of
    the output's max-abs, a bound the plain f32 version's own sums do not
    meet at D = 2^22 with bf16 streams (there the kernel-vs-plain gap is
    the plain version's)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    Xq = _rnd(gen, 64, d, dtype=dtype)
    X = _rnd(gen, 16, d, dtype=dtype)
    lam = torch.tensor(1.0 / d, device="cuda")
    for A, B in ((Xq, X), (X, X)):
        exact = (A.double() * lam.double()) @ B.double().T
        got = ops.skinny_gram(A, B, lam)
        assert _rel(got.cpu().numpy(), exact.cpu().numpy()) <= 1e-6
