"""Carry a posterior state across from the JAX package, and back.

The JAX package's ``GPGData`` is handed over as a dict of numpy arrays
(``{k: np.asarray(v) for k, v in data._asdict().items()}``), so this module
needs neither JAX nor the ``repro`` package. The host knobs that the JAX
``GPGState`` keeps beside its data (kernel, window, noise, jitter, tol, ...)
are passed as keyword arguments.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import backend
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
