"""Serving configuration of the port (counterpart of the GPServeConfig in
``repro/configs/paper_gp.py``)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GPServeConfig:
    """Knobs of the batched posterior-query serving path (train/serve.py).

    ``precision`` selects the STREAM storage dtype of the (N, D) operands
    the query path reads: 'bf16' halves their bytes while every
    contraction still accumulates in f32 (the bf16 state streams are a
    later slice of the port; this slice serves 'f32').

    ``tol``/``maxiter`` are the served state's CG solve knobs (the
    warm-started re-solve each ``extend`` runs); ``maxiter=None`` takes
    the ``10*capacity + 50`` ceiling (``core.state._default_maxiter``).
    """

    microbatch: int = 64
    precision: str = "f32"       # 'f32' | 'bf16' stream storage
    tol: float = 1e-10           # CG residual tolerance of state solves
    maxiter: int | None = None   # CG budget; None = the capacity ceiling


GP_SERVE = GPServeConfig()
