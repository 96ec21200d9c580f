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
    """The one split plan, which every split-D library exports: every
    column of D in exactly one slice, whole 256-column quanta cut into at
    most one slice per SM of this card, the same in every library."""
    from repro_torch.kernels import _build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {_build.split_plan(name, d) for name in _build.STAGE}
    assert len(plans) == 1
    G, chunk = plans.pop()
    assert (G - 1) * chunk < d <= G * chunk
    assert chunk % 256 == 0 and 1 <= G <= sms


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
    # The same for the norms and full modes. splitk.cuh's first stage took
    # at most 235 rows of B beside 64 of A in fused_gram_norms and 121 rows
    # of B and of V in fused_factor_build (48 KB of one-tile staging); the
    # stage takes at least those, narrow sub-tiles keeping three stages.
    for lib, least, ring in (
            ("fused_gram_norms", 235, lambda k: _build.stage_ring(
                "fused_gram_norms", 0, 0, 64, k)),
            ("fused_factor_build", 121, lambda k: _build.stage_ring(
                "fused_factor_build", 0, 0, 64, k, v_code=0))):
        nb = max(k for k in range(1, 1024) if ring(k) > 0)
        assert nb >= least and ring(nb + 1) < 0
        for rows, fits in ((nb, True), (nb + 1, False)):
            B = _rnd(gen, rows, 1000)
            call = ((lambda: ops.fused_gram_norms(A, B, 0.5))
                    if lib == "fused_gram_norms" else
                    (lambda: ops.fused_factor_build(A, B, B.clone(), 0.5)))
            if not fits:
                with pytest.raises(ValueError, match="not supported"):
                    call()
                continue
            want = (ref.fused_gram_norms_ref(A, B, 0.5)
                    if lib == "fused_gram_norms" else
                    ref.fused_factor_build_ref(A, B, B, 0.5, 1.0))
            for g, w in zip(call(), want):
                assert _rel(g.cpu().numpy(), w.cpu().numpy()) <= F32_TOL


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


def _stage_d(d, lib, a_dtype, b_dtype, na, nb, per_lane, **ring_kw):
    if not isinstance(d, str):
        return d
    from repro_torch.kernels import _build

    ring = _build.stage_ring(lib, CODES[a_dtype], CODES[b_dtype], na, nb,
                             vec_lam=per_lane, **ring_kw)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ring + (1 if d == "ring+1" else -1)


def _rows(gen, n, d, dtype=torch.float32):
    """n rows of noise about distinct means 1 + j/n: no output of B1 or B4
    sums to near zero (a one-entry output that cancels would make the
    error relative to its max-abs meaningless), and two rows never give
    the same sums, so a row read in the wrong place shows."""
    mean = 1.0 + torch.arange(n, device="cuda")[:, None] / n
    return (_rnd(gen, n, d) + mean).to(dtype)


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


# fused_factor_build's three ways of reading its streams: V distinct, V is
# B (the extend border) and B is A (the bundle sweep), at the stage's row
# counts.
FFB_CASES = ([(na, nb, "V") for na in (1, 5, 16, 64) for nb in (1, 16)]
             + [(na, nb, "V=B") for na in (1, 5, 16, 64) for nb in (1, 16)]
             + [(n, n, "A=B") for n in (1, 5, 16, 64)])


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("na,nb,mode", FFB_CASES)
def test_factor_build_stage_widths_on_card(sm90, na, nb, mode, dtype,
                                           per_lane):
    """B1 in the stage's full mode at every width of STAGE_DS: A and B
    stored in ``dtype``, a distinct V in f32 (the solve Z); lam and v_scale
    both scalars or both (D,). The widths run in one test each (a case
    apiece would add a thousand skips to the CPU run)."""
    v_is_b = mode == "V=B"
    for d in STAGE_DS:
        d = _stage_d(d, "fused_factor_build", dtype, dtype, na, nb, per_lane,
                     sym=mode == "A=B", v_is_b=v_is_b, vec_vs=per_lane,
                     v_code=CODES[dtype] if v_is_b else 0)
        gen = torch.Generator(device="cuda").manual_seed(na * 100 + nb)
        A = _rows(gen, na, d, dtype=dtype)
        B = A if mode == "A=B" else _rows(gen, nb, d, dtype=dtype)
        V = None if v_is_b else _rows(gen, nb, d)
        lam, vs = _stage_lam(gen, per_lane, d), _stage_lam(gen, per_lane, d)
        got = ops.fused_factor_build(A, B, V, lam, v_scale=vs)
        want = ref.fused_factor_build_ref(A, B, V, lam, vs)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rel(g.cpu().numpy(), w.cpu().numpy()) <= F32_TOL, d


GFN_CASES = ([(na, nb, False) for na in (1, 5, 16, 64) for nb in (1, 16)]
             + [(n, n, True) for n in (1, 5, 16, 64)])


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("na,nb,sym", GFN_CASES)
def test_gram_norms_stage_widths_on_card(sm90, na, nb, sym, dtype, per_lane):
    """B4 in the stage's norms mode, and in its symmetric P mode (one
    tensor as A and B: na = nb off P's diagonal), at every width of
    STAGE_DS."""
    for d in STAGE_DS:
        d = _stage_d(d, "fused_gram_norms", dtype, dtype, na, nb, per_lane,
                     sym=sym)
        gen = torch.Generator(device="cuda").manual_seed(na * 10 + nb)
        A = _rows(gen, na, d, dtype=dtype)
        B = A if sym else _rows(gen, nb, d, dtype=dtype)
        lam = _stage_lam(gen, per_lane, d)
        for g, w in zip(ops.fused_gram_norms(A, B, lam),
                        ref.fused_gram_norms_ref(A, B, lam)):
            assert g.shape == w.shape
            assert _rel(g.cpu().numpy(), w.cpu().numpy()) <= F32_TOL, d


@pytest.mark.gpu
@LANES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_kernels_bitwise_repeatable_on_card(sm90, dtype, per_lane):
    """Two launches on the same inputs give the same bits (no atomics)."""
    d = 1_000_003
    gen = torch.Generator(device="cuda").manual_seed(3)
    A, B = _rnd(gen, 64, d, dtype=dtype), _rnd(gen, 16, d, dtype=dtype)
    x = _rnd(gen, 1, d, dtype=dtype)
    K1e, K2e = _rnd(gen, 16, 16), _rnd(gen, 16, 16)
    V = _rnd(gen, 4, 16, d)
    lam = _stage_lam(gen, per_lane, d)
    calls = (lambda: ops.skinny_gram(A, B, lam),
             lambda: ops.skinny_gram(B, B, lam),
             lambda: ops.fused_gram_mvm(K1e, K2e, B, V[0], lam,
                                        stationary=True),
             lambda: ops.fused_gram_mvm(K1e, K2e, B, V, lam,
                                        stationary=False),
             lambda: ops.fused_factor_build(A, B, V[0], lam, v_scale=lam),
             lambda: ops.fused_factor_build(B, x, None, lam),
             lambda: ops.fused_factor_build(B, B, V[1], lam),
             lambda: ops.fused_gram_norms(A, B, lam),
             lambda: ops.fused_gram_norms(B, B, lam))
    for call in calls:
        one, two = call(), call()
        for a, b in zip(one if isinstance(one, tuple) else (one,),
                        two if isinstance(two, tuple) else (two,)):
            assert torch.equal(a, b)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1_000_003, 4_194_304])
def test_fused_factor_build_against_float64_on_card(sm90, d, dtype):
    """B1's sums against float64 sums of the same stored values (scalar
    lam = v_scale = 1/D, V in f32), at the query shape, the bundle's A = B
    and the border's V = B: every output within 2e-6 of its max-abs. The
    full mode sums about 2,000 products a lane in sequence (16 lanes x 2
    columns a stripe), twice skinny_gram's run: a numpy model of that order
    puts a zero-mean query output's f32 error near 1e-6 of the max-abs at
    D = 2^22."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    Xq = _rnd(gen, 64, d, dtype=dtype)
    X = _rnd(gen, 16, d, dtype=dtype)
    x = _rnd(gen, 1, d, dtype=dtype)
    Z = _rnd(gen, 16, d)
    lam = torch.tensor(1.0 / d, device="cuda")
    for A, B, V in ((Xq, X, Z), (X, X, Z), (X, x, None)):
        got = ops.fused_factor_build(A, B, V, lam, v_scale=lam)
        Vd = (B if V is None else V).double()
        Ad, Bd, ld = A.double(), B.double(), lam.double()
        exact = ((Ad * ld) @ Bd.T, ((Ad * ld) * Ad).sum(1),
                 ((Bd * ld) * Bd).sum(1), (Vd * ld) @ Ad.T,
                 ((Bd * ld) * Vd).sum(1))
        for g, w in zip(got, exact):
            assert _rel(g.cpu().numpy(), w.cpu().numpy()) <= 2e-6
