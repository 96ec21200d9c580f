"""Wrappers around the port's hand-written CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything its kernel does not take. The device of the tensors decides the
route: tensors on the CPU go to the plain version in ``ref.py``; CUDA
tensors launch the kernel (f32 or bf16 storage per stream, f32 outputs)
on PyTorch's current stream, or raise. There is no third route.

``launches`` counts the wrapper calls that launched a kernel (one call of
``fused_gram_mvm`` is three CUDA launches in stream order and counts once;
``fused_gram_mvm_phases`` makes them apart, for timing, and counts none).
``fused_gram_mvm`` with a stacked (R, N, D) V is the multi-RHS form, which
counts as ``fused_gram_mvm_multi``.

lam, v_scale and scale may each be a Python number, a 0-d / one-element
tensor or a (D,) tensor. The kernels mask the ragged end of D themselves,
so no input is padded or copied.
"""
from __future__ import annotations

import torch

from . import _build, ref

Tensor = torch.Tensor

launches = {"fused_factor_build": 0, "gram_update": 0, "fused_gram_mvm": 0,
            "skinny_gram": 0, "fused_gram_norms": 0, "small_matmul": 0,
            "fused_gram_mvm_multi": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_2d(name: str, **tensors: Tensor) -> None:
    for key, t in tensors.items():
        if not isinstance(t, Tensor) or t.ndim != 2 or t.numel() == 0:
            raise ValueError(f"{name}: {key} must be a non-empty 2-D "
                             f"tensor, got {getattr(t, 'shape', type(t))}")


def _on_cpu(name: str, *tensors: Tensor) -> bool:
    """True for all-CPU inputs, False for all-CUDA; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return False


def _contiguous(name: str, *tensors: Tensor) -> None:
    """Both routes hold the kernel's layout contract, so the CPU tests see
    what the card would refuse."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _stream_code(name: str, *streams: Tensor) -> int:
    """The storage code of streams that must share one dtype."""
    dts = {t.dtype for t in streams}
    if len(dts) != 1 or next(iter(dts)) not in _DTYPE_CODES:
        raise ValueError(f"{name}: the kernel takes f32 or bf16 streams, "
                         f"got {dts}")
    return _DTYPE_CODES[next(iter(dts))]


def _f32_small(name: str, *mats: Tensor) -> None:
    for m in mats:
        if m.dtype != torch.float32:
            raise ValueError(f"{name}: (N, N) operands must be f32, got "
                             f"{m.dtype}")


def _lane(name: str, x, d: int, device) -> tuple[Tensor, int]:
    """A per-lane factor as (contiguous f32 tensor on device, stride)."""
    if not isinstance(x, Tensor):
        return torch.full((1,), float(x), dtype=torch.float32,
                          device=device), 0
    if x.device != device:
        raise ValueError(f"{name}: lam/v_scale on {x.device}, streams on "
                         f"{device}")
    if x.numel() == 1:
        return x.reshape(1).to(torch.float32), 0
    if x.shape != (d,):
        raise ValueError(f"{name}: lam/v_scale must be a scalar or ({d},), "
                         f"got {tuple(x.shape)}")
    return x.to(torch.float32).contiguous(), 1


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(name: str, code: int) -> None:
    if code == 0:
        return
    msg = f"{name} kernel: {_build.error_string(name, code)} (code {code})"
    if code < 0:
        raise ValueError(msg)
    raise RuntimeError(msg)


def _same(X: Tensor, Y: Tensor) -> bool:
    """One tensor passed twice (same data pointer, shape and dtype): the
    card reads its rows once."""
    return (X.data_ptr() == Y.data_ptr() and X.shape == Y.shape
            and X.dtype == Y.dtype)


def fused_factor_build(A: Tensor, B: Tensor, V: Tensor | None, lam, *,
                       v_scale=1.0):
    """(P, na, nb, C, tv) in one read of A, B, V.

    A: (Na, D), B: (Nb, D), V: (Nb, D) or None to reuse B. Returns
    P = (A*lam) @ B^T (Na, Nb), row norms na (Na,) / nb (Nb,),
    C = (V*v_scale) @ A^T (Nb, Na) and tv = rowdots(B, V, lam) (Nb,).
    When B is A (the bundle sweep) or V is B (the extend border) the card
    reads that tensor's rows once.
    """
    name = "fused_factor_build"
    if V is None:
        V = B
    _check_2d(name, A=A, B=B, V=V)
    if V.shape != B.shape or A.shape[1] != B.shape[1]:
        raise ValueError(f"{name}: shapes A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, V {tuple(V.shape)} do not fit")
    _contiguous(name, A, B, V)
    if _on_cpu(name, A, B, V):
        return ref.fused_factor_build_ref(A, B, V, lam, v_scale)
    codes = _stream_code(name, A, B), _stream_code(name, V)
    na, d = A.shape
    nb = B.shape[0]
    dev = A.device
    lam_t, lam_s = _lane(name, lam, d, dev)
    vs_t, vs_s = _lane(name, v_scale, d, dev)
    width = 2 * na * nb + na + 2 * nb
    with torch.cuda.device(dev):
        G, _ = _build.split_plan(name, d)
        # the partial rows leave out what B is A or V is B make redundant,
        # so the reduced row's width bounds them
        part = torch.empty((G, width), dtype=torch.float32, device=dev)
        out = torch.empty((width,), dtype=torch.float32, device=dev)
        err = _build.launcher(name)(
            *codes, A.data_ptr(), B.data_ptr(), V.data_ptr(), lam_t.data_ptr(),
            lam_s, vs_t.data_ptr(), vs_s, na, nb, int(_same(A, B)),
            int(_same(V, B)), d, part.data_ptr(), out.data_ptr(),
            _stream_ptr(dev))
    _raise_on(name, err)
    launches[name] += 1
    k = na * nb
    return (out[:k].view(na, nb), out[2 * k:2 * k + na],
            out[2 * k + na:2 * k + na + nb], out[k:2 * k].view(nb, na),
            out[2 * k + na + nb:])


def gram_update(K1: Tensor, M: Tensor, V: Tensor, X: Tensor, lam, *,
                v_scale=None, noise: float = 0.0) -> Tensor:
    """W = (K1 @ (V*v_scale) + M @ X) * lam + noise*V.

    K1, M: (Nq, N); V, X: (N, D) streamed; W: (Nq, D). The noise ridge
    needs Nq == N.
    """
    name = "gram_update"
    _check_2d(name, K1=K1, M=M, V=V, X=X)
    n, d = V.shape
    nq = K1.shape[0]
    if X.shape != V.shape or K1.shape != (nq, n) or M.shape != (nq, n):
        raise ValueError(f"{name}: shapes K1 {tuple(K1.shape)}, M "
                         f"{tuple(M.shape)}, V {tuple(V.shape)}, X "
                         f"{tuple(X.shape)} do not fit")
    if noise and nq != n:
        raise ValueError(f"{name}: the noise ridge needs a square update")
    _contiguous(name, K1, M, V, X)
    if _on_cpu(name, K1, M, V, X):
        return ref.gram_update_ref(K1, M, V, X, lam, v_scale, noise)
    codes = _stream_code(name, V), _stream_code(name, X)
    _f32_small(name, K1, M)
    dev = V.device
    lam_t, lam_s = _lane(name, lam, d, dev)
    vs_t, vs_s = (None, 0) if v_scale is None else _lane(name, v_scale, d,
                                                         dev)
    W = torch.empty((nq, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.launcher(name)(
            *codes, K1.data_ptr(), M.data_ptr(), V.data_ptr(), X.data_ptr(),
            lam_t.data_ptr(), lam_s, None if vs_t is None else vs_t.data_ptr(),
            vs_s, float(noise), nq, n, d, W.data_ptr(), _stream_ptr(dev))
    _raise_on(name, err)
    launches[name] += 1
    return W


def _gram_mvm_shapes(name: str, K1e: Tensor, K2e: Tensor, Xt: Tensor,
                     V: Tensor) -> tuple[int, int, int]:
    """Checks of the Gram MVM's operands; returns (R, N, D)."""
    _check_2d(name, K1e=K1e, K2e=K2e, Xt=Xt)
    stacked = isinstance(V, Tensor) and V.ndim == 3
    if not stacked:
        _check_2d(name, V=V)
    elif V.numel() == 0:
        raise ValueError(f"{name}: V must be a non-empty (N, D) or "
                         f"(R, N, D) tensor, got {tuple(V.shape)}")
    r, n, d = V.shape if stacked else (1, *V.shape)
    if Xt.shape != (n, d) or K1e.shape != (n, n) or K2e.shape != (n, n):
        raise ValueError(f"{name}: shapes K1e {tuple(K1e.shape)}, K2e "
                         f"{tuple(K2e.shape)}, Xt {tuple(Xt.shape)}, V "
                         f"{tuple(V.shape)} do not fit")
    _contiguous(name, K1e, K2e, Xt, V)
    return r, n, d


def _gram_mvm_card(name: str, K1e: Tensor, K2e: Tensor, Xt: Tensor,
                   V: Tensor, lam, stationary: bool, noise: float):
    """W and ``launch(phases)``, which makes the library's launches of the
    ``phases`` mask (1 first stage, 2 fold, 4 output stream) on W and the
    scratch allocated here."""
    lib = "fused_gram_mvm"
    codes = _stream_code(name, Xt), _stream_code(name, V)
    _f32_small(name, K1e, K2e)
    r, n, d = V.shape if V.ndim == 3 else (1, *V.shape)
    dev = V.device
    lam_t, lam_s = _lane(name, lam, d, dev)
    with torch.cuda.device(dev):
        G, _ = _build.split_plan(lib, d)
    part = torch.empty((G, r * n * n), dtype=torch.float32, device=dev)
    small = torch.empty((r, n, n), dtype=torch.float32, device=dev)
    W = torch.empty(V.shape, dtype=torch.float32, device=dev)

    def launch(phases: int) -> None:
        with torch.cuda.device(dev):
            err = _build.launcher(lib)(
                *codes, K1e.data_ptr(), K2e.data_ptr(), Xt.data_ptr(),
                V.data_ptr(), lam_t.data_ptr(), lam_s, float(noise),
                int(bool(stationary)), r, n, d, part.data_ptr(),
                small.data_ptr(), W.data_ptr(), phases, _stream_ptr(dev))
        _raise_on(lib, err)

    return W, launch


def fused_gram_mvm(K1e: Tensor, K2e: Tensor, Xt: Tensor, V: Tensor, lam, *,
                   stationary: bool, noise: float = 0.0) -> Tensor:
    """The full Alg.-2 Gram MVM W = (K1e @ V + small @ Xt) * lam + noise*V.

    K1e, K2e: (N, N); Xt, V: (N, D). ``small`` is K2e * M for dot kernels
    and diag(rowsum(Mt)) - Mt, Mt = K2e * (M - diag(M)), for stationary
    ones, with M = (Xt*lam) @ V^T. A stacked V (R, N, D) gives W
    (R, N, D), one product per right-hand side, with Xt streamed once for
    all of them; the card refuses (ValueError) an R * N^2 past the
    kernel's shared-memory budget, as the TPU wrapper refuses one past
    VMEM. Both forms launch one library; a stacked V counts as
    ``fused_gram_mvm_multi``.
    """
    stacked = isinstance(V, Tensor) and V.ndim == 3
    name = "fused_gram_mvm_multi" if stacked else "fused_gram_mvm"
    _gram_mvm_shapes(name, K1e, K2e, Xt, V)
    if _on_cpu(name, K1e, K2e, Xt, V):
        return ref.fused_gram_mvm_ref(K1e, K2e, Xt, V, lam,
                                      stationary=stationary, noise=noise)
    W, launch = _gram_mvm_card(name, K1e, K2e, Xt, V, lam, stationary,
                               noise)
    launch(7)
    launches[name] += 1
    return W


def fused_gram_mvm_phases(K1e: Tensor, K2e: Tensor, Xt: Tensor, V: Tensor,
                          lam, *, stationary: bool, noise: float = 0.0):
    """The card's three launches of one ``fused_gram_mvm`` call, apart:
    [("first stage", fn), ("fold", fn), ("stream", fn)], each fn making that
    launch alone on buffers that one whole product filled first. For
    timing each launch; counts no launch. CUDA tensors only."""
    name = "fused_gram_mvm"
    _gram_mvm_shapes(name, K1e, K2e, Xt, V)
    if _on_cpu(name, K1e, K2e, Xt, V):
        raise ValueError(f"{name}: the phases are launches on the card")
    _, launch = _gram_mvm_card(name, K1e, K2e, Xt, V, lam, stationary,
                               noise)
    launch(7)
    return [(label, lambda m=mask: launch(m))
            for label, mask in (("first stage", 1), ("fold", 2),
                                ("stream", 4))]


def _gram_pair(name: str, A: Tensor, B: Tensor):
    """Checks shared by the two (A, B) split-D kernels; returns (Na, Nb, D)."""
    _check_2d(name, A=A, B=B)
    if A.shape[1] != B.shape[1]:
        raise ValueError(f"{name}: shapes A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)} do not fit")
    _contiguous(name, A, B)
    return A.shape[0], B.shape[0], A.shape[1]


def _launch_gram_pair(name: str, A: Tensor, B: Tensor, lam, width: int,
                      *flags: int) -> Tensor:
    """Launch a split-D (A, B) kernel whose reduced row is ``width``
    floats, passing ``flags`` after the row counts; returns that row."""
    na, d = A.shape
    nb = B.shape[0]
    codes = _stream_code(name, A), _stream_code(name, B)
    dev = A.device
    lam_t, lam_s = _lane(name, lam, d, dev)
    with torch.cuda.device(dev):
        G, _ = _build.split_plan(name, d)
    part = torch.empty((G, width), dtype=torch.float32, device=dev)
    out = torch.empty((width,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.launcher(name)(
            *codes, A.data_ptr(), B.data_ptr(), lam_t.data_ptr(), lam_s, na,
            nb, *flags, d, part.data_ptr(), out.data_ptr(), _stream_ptr(dev))
    _raise_on(name, err)
    launches[name] += 1
    return out


def skinny_gram(A: Tensor, B: Tensor, lam) -> Tensor:
    """P = (A*lam) @ B^T (Na, Nb); A: (Na, D), B: (Nb, D) streamed once.

    When B is A (same data pointer, shape and dtype, as in
    ``build_factors(X, X)``) the card reads its rows once."""
    name = "skinny_gram"
    na, nb, _ = _gram_pair(name, A, B)
    if _on_cpu(name, A, B):
        return ref.skinny_gram_ref(A, B, lam)
    return _launch_gram_pair(name, A, B, lam, na * nb,
                             int(_same(A, B))).view(na, nb)


def fused_gram_norms(A: Tensor, B: Tensor, lam):
    """(P, na, nb) in one read of A and B: P = (A*lam) @ B^T (Na, Nb) and
    the lam-weighted row norms na (Na,) and nb (Nb,). When B is A (as in
    ``build_factors(X, X)`` and ``from_data``) the card reads its rows
    once."""
    name = "fused_gram_norms"
    na, nb, _ = _gram_pair(name, A, B)
    if _on_cpu(name, A, B):
        return ref.fused_gram_norms_ref(A, B, lam)
    k = na * nb
    out = _launch_gram_pair(name, A, B, lam, k + na + nb, int(_same(A, B)))
    return out[:k].view(na, nb), out[k:k + na], out[k + na:]


def small_matmul(K: Tensor, V: Tensor, scale=1.0) -> Tensor:
    """W = (K @ V) * scale; K: (Nq, N) f32 on the card, V: (N, D) streamed.

    The Kronecker-preconditioner application (scale = 1/lam): one read of
    V and one write of W.
    """
    name = "small_matmul"
    _check_2d(name, K=K, V=V)
    n, d = V.shape
    nq = K.shape[0]
    if K.shape != (nq, n):
        raise ValueError(f"{name}: shapes K {tuple(K.shape)}, V "
                         f"{tuple(V.shape)} do not fit")
    _contiguous(name, K, V)
    if _on_cpu(name, K, V):
        return ref.small_matmul_ref(K, V, scale)
    code = _stream_code(name, V)
    _f32_small(name, K)
    dev = V.device
    s_t, s_s = _lane(name, scale, d, dev)
    W = torch.empty((nq, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.launcher(name)(
            code, K.data_ptr(), V.data_ptr(), s_t.data_ptr(), s_s, nq, n, d,
            W.data_ptr(), _stream_ptr(dev))
    _raise_on(name, err)
    launches[name] += 1
    return W
