"""Carry a posterior state or a factor set across from the JAX package,
and back.

The JAX package's ``GPGData`` and ``GramFactors`` are handed over as dicts
of numpy arrays (``{k: np.asarray(v) for k, v in x._asdict().items()}``,
None kept as None), so this module needs neither JAX nor the ``repro``
package. The host knobs that the JAX ``GPGState`` keeps beside its data
(kernel, window, noise, jitter, tol, ...) are passed as keyword arguments.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import backend
from repro_torch.core.gram import GramFactors
from repro_torch.core.state import GPGData, GPGState

_STREAMS = ("X", "G", "Xt", "K1e", "K2e", "L", "Z", "lam")
_COUNTERS = ("count", "n_refactor", "n_solve", "cg_iters")


def data_from_numpy(arrays: dict, *, device=None, dtype=None) -> GPGData:
    """The port's ``GPGData`` from the numpy arrays of a JAX ``GPGData``."""
    device = backend.resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    c = arrays.get("c")
    return GPGData(
        **{k: t(arrays[k]) for k in _STREAMS},
        **{k: int(arrays[k]) for k in _COUNTERS},
        resnorm=float(arrays["resnorm"]),
        c=None if c is None else t(c),
    )


def data_to_numpy(data: GPGData) -> dict:
    """The numpy arrays of a port ``GPGData``, keyed as the JAX fields."""
    out = {k: getattr(data, k).detach().cpu().numpy() for k in _STREAMS}
    out.update({k: np.asarray(getattr(data, k), np.int32)
                for k in _COUNTERS})
    out["resnorm"] = np.asarray(data.resnorm)
    out["c"] = None if data.c is None else data.c.detach().cpu().numpy()
    return out


def state_from_numpy(arrays: dict, *, kernel: str, window: int | None = None,
                     noise: float = 0.0, signal: float = 1.0,
                     jitter: float = 1e-10, deg_thresh: float = 1e-8,
                     tol: float = 1e-10, maxiter: int | None = None,
                     device=None, dtype=None) -> GPGState:
    """A port ``GPGState`` holding a JAX state's data and host knobs."""
    data = data_from_numpy(arrays, device=device, dtype=dtype)
    if window is not None and window != data.capacity:
        raise ValueError(f"window {window} != the data's capacity "
                         f"{data.capacity}")
    st = GPGState(kernel, data.d, capacity=data.capacity, window=window,
                  lam=data.lam, noise=noise, signal=signal, jitter=jitter,
                  deg_thresh=deg_thresh, tol=tol, maxiter=maxiter,
                  dtype=data.X.dtype, device=data.X.device)
    st.data = data
    return st


def factors_from_numpy(arrays: dict, *, device=None,
                       dtype=None) -> GramFactors:
    """The port's ``GramFactors`` from the numpy arrays of a JAX one.

    The JAX ``shift`` field (a bf16 stream frame of its query path) has no
    counterpart here: factors carrying one are refused.
    """
    if arrays.get("shift") is not None:
        raise ValueError("factors with a stream shift cannot be carried "
                         "across: pass the unshifted f32 factors")
    device = backend.resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    c = arrays.get("c")
    return GramFactors(K1e=t(arrays["K1e"]), K2e=t(arrays["K2e"]),
                       Xt=t(arrays["Xt"]), lam=t(arrays["lam"]),
                       noise=float(arrays.get("noise", 0.0)),
                       c=None if c is None else t(c))


def factors_to_numpy(f: GramFactors) -> dict:
    """The numpy arrays of a port ``GramFactors``, keyed as the JAX
    fields."""
    a = lambda x: np.asarray(x.detach().cpu().numpy()
                             if isinstance(x, torch.Tensor) else x)
    return {"K1e": a(f.K1e), "K2e": a(f.K2e), "Xt": a(f.Xt), "lam": a(f.lam),
            "noise": float(f.noise), "c": None if f.c is None else a(f.c),
            "shift": None}
