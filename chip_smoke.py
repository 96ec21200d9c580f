#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure exits non-zero, and the last line (the result) is
printed only when every phase passed:

  1. the card: name and power limit from nvidia-smi, capability (9, 0);
  2. build the seven CUDA kernels from src/repro_torch/kernels/csrc;
  3. each kernel against its plain PyTorch version on the card, at the
     paths' shapes (D = 4,194,304) and at a ragged D = 1,000,003, with
     f32 and bf16 stream storage and both stationary flags, and at the
     ragged D with per-lane (D,) lam and v_scale as well as scalar ones;
     two launches on the same inputs must agree bit for bit (no
     atomics); kernel, plain-version and bound times, the time of one
     PyTorch call computing the same function where there is one, and
     the Gram MVMs' three launches (first stage, fold, output stream)
     timed apart. The A = B cases pass one tensor twice, as
     build_factors(X, X) and the bundle sweep do: the symmetric mode of
     the split-D stage;
  4. the main path at full width: an rbf ``GPGState`` with D = 4,194,304
     and a window of 16 takes 24 observations of a seeded random walk (8
     evictions), then ``build_gp_serve_step`` answers 4 requests of 64
     queries. Every kernel must have launched and no plain version may
     have run on a CUDA tensor. Z after every extend and the posterior
     value and grad are held against an independent float64 run of the
     same method through the plain versions on the card (same window,
     same warm starts, as many CG steps as the port took), and that run's
     own residual must reach the CG tolerance after every extend, so the
     port's step counts are shown to solve the system; the distance to
     the exact solve (CG to 1e-12) is printed beside it. Then
     torch.profiler shows where the time of one more extend and one more
     request goes;
  5. the batch path at full width, on the last 16 observations of phase
     4's walk and its first query batch: the exact Woodbury solve from one
     factor sweep, bulk conditioning (GPGState.from_data), Kronecker-
     preconditioned CG with one and with 4 stacked right-hand sides,
     posterior value and gradient at 64 queries, the GP-H and GP-X
     directions, the poly2 closed-form solve of a quadratic, and the
     quickstart's Hessian-probe query on phase 4's state. Every kernel
     must have launched and no plain version may have run on a CUDA
     tensor; every result is held against the same calls of the port on
     the CPU in float64 (the CG solves against the float64 Woodbury
     solve of each right-hand side). Then torch.profiler shows where the
     time of one Woodbury solve and one CG solve goes.

``--out PATH`` also writes the detailed numbers there as JSON. ``--src
DIR`` imports and builds the port from DIR (another tree's ``src``, e.g.
an unpacked parent commit) instead of this checkout's, so that two trees
are timed by one script; a tree without ``fused_gram_mvm_phases`` prints
no per-launch times. Imports torch and the port, never JAX and nothing of
the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

D_PATH = 4_194_304
D_RAGGED = 1_000_003
WINDOW = 16
N_OBS = 24
REQUESTS = 4
QUERIES = 64
NOISE = 1e-6
CG_TOL = 1e-5
# Phase 5: stacked right-hand sides, the batch CG tolerance and an explicit
# step budget (gram_cg_solve's default, N * D, would be 67M host round
# trips), and the quickstart's probe queries.
R_STACK = 4
BATCH_CG_TOL = 1e-6
BATCH_MAXITER = 200
PROBE_QUERIES = 2
# Kernel vs plain version, relative to the output's max-abs: both sum up to
# 4M f32 terms, in different orders (split-D partials vs cuBLAS).
KERNEL_TOL = 1e-5
# Port (f32 storage and accumulation) vs the float64 plain run of the same
# method. Both take the port's CG step counts, which must bring the float64
# run's residual to CG_TOL (1e-10 cannot be reached in f32), so what differs
# is the f32 arithmetic of two solves stopped at 1e-5. Phase 5 holds every
# batch result to the same limit against the port's float64 CPU run; f32
# against f64 on this walk measured 2e-5 at most at D = 4096 (the small
# algebra does not depend on D at lam = 1/D).
PATH_TOL = 1e-3
# Published H100 SXM peaks (NVIDIA data sheet), at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

REPLACES = {
    "fused_factor_build":
        "src/repro/kernels/fused_factor_build.py:49",
    "gram_update": "src/repro/kernels/gram_update.py:36",
    "fused_gram_mvm": "src/repro/kernels/fused_gram_mvm.py:73",
    "fused_gram_norms": "src/repro/kernels/fused_gram_norms.py:22",
    "skinny_gram": "src/repro/kernels/skinny_gram.py:28",
    "small_matmul": "src/repro/kernels/gram_update.py:50",
    "fused_gram_mvm_multi": "src/repro/kernels/fused_gram_mvm.py:138",
}
# Kernels whose source is not csrc/<name>.cu: the stacked Gram MVM is the
# single one's library with R right-hand sides.
SOURCE = {"fused_gram_mvm_multi": "fused_gram_mvm"}
# The kernels phase 4's extend/serve path runs; phase 5 runs all seven.
PATH4_KERNELS = ("fused_factor_build", "gram_update", "fused_gram_mvm",
                 "small_matmul")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# Device cycles of the spin kernel that runs ahead of each timed window
# (about 10 ms at the H100's clocks), so that the host enqueues the launches
# while the card is busy and the events bracket device time, not launch gaps
# (a launch shorter than the wrapper's host time would read as the latter).
SPIN_CYCLES = 20_000_000


def time_ms(torch, fn, reps=10) -> float:
    """Mean device time of fn over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, flops: float):
    """(least ms the card could take, what bounds it)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def rel_err(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rel = absolute = 0.0
    for g, w in zip(got, want):
        diff = float((g.double() - w.double()).abs().max())
        rel = max(rel, diff / max(float(w.double().abs().max()), 1e-300))
        absolute = max(absolute, diff)
    return rel, absolute


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(torch, d, bf16, lanes, gen):
    """(kernel, label, kernel call, plain call, bytes, flops, library
    call or None, phases or None) at the paths' shapes for one D and one
    stream storage; ``lanes`` passes lam and v_scale as (D,) vectors
    instead of scalars. The library call is one PyTorch call computing the
    same function (at f32 and a scalar factor only), timed as a yardstick.
    ``phases()`` gives a Gram MVM's launches as separate calls, each timed
    on its own."""
    from repro_torch.kernels import ops, ref

    split = getattr(ops, "fused_gram_mvm_phases", None)
    f32 = torch.float32
    sdt = torch.bfloat16 if bf16 else f32
    es = 2 if bf16 else 4

    def rnd(*shape, dtype=f32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    if lanes:
        lam = (0.5 + torch.rand(d, generator=gen, device="cuda")) / d
        vs = (0.5 + torch.rand(d, generator=gen, device="cuda")) / d
        tag, lane_bytes = " (D,)", 4 * d
    else:
        lam = vs = torch.tensor(1.0 / d, device="cuda")
        tag, lane_bytes = "", 4
    Xq, Xt, x = rnd(64, d, dtype=sdt), rnd(16, d, dtype=sdt), rnd(1, d,
                                                                  dtype=sdt)
    Z = rnd(16, d)                       # solve outputs stay f32
    Vm = rnd(R_STACK, 16, d)             # stacked CG directions, f32
    K1, M = rnd(64, 16), rnd(64, 16)
    K1e, K2e = rnd(16, 16), rnd(16, 16)
    out = []
    na, nb = 64, 16
    library = not (bf16 or lanes)
    out.append((
        "fused_factor_build", "query (64,16)" + tag,
        lambda: ops.fused_factor_build(Xq, Xt, Z, lam, v_scale=vs),
        lambda: ref.fused_factor_build_ref(Xq, Xt, Z, lam, vs),
        (na + nb) * d * es + nb * d * 4 + 2 * lane_bytes
        + 4 * (2 * na * nb + na + 2 * nb),
        4 * na * nb * d + 4 * na * d + 7 * nb * d, None, None))
    out.append((
        "fused_factor_build", "border (16,1)" + tag,
        lambda: ops.fused_factor_build(Xt, x, None, lam),
        lambda: ref.fused_factor_build_ref(Xt, x, None, lam),
        17 * d * es + lane_bytes + 4 * (2 * 16 + 16 + 2),
        4 * 16 * d + 4 * 16 * d + 7 * d, None, None))
    # the bundle sweep (build_factor_bundle, Woodbury): one tensor as A and
    # B, so the bound reads Xt once; G is f32; v_scale is 1 on the path
    bvs = vs if lanes else 1.0
    out.append((
        "fused_factor_build", "bundle A=B (16,16)" + tag,
        lambda: ops.fused_factor_build(Xt, Xt, Z, lam, v_scale=bvs),
        lambda: ref.fused_factor_build_ref(Xt, Xt, Z, lam, bvs),
        16 * d * es + 16 * d * 4 + 2 * lane_bytes
        + 4 * (2 * 16 * 16 + 3 * 16),
        4 * 16 * 16 * d + 4 * 16 * d + 7 * 16 * d, None, None))
    # the query path passes no v_scale; the per-lane case covers that
    # stride too
    gu_vs = vs if lanes else None
    out.append((
        "gram_update", "query (64,16)" + tag,
        lambda: ops.gram_update(K1, M, Z, Xt, lam, v_scale=gu_vs),
        lambda: ref.gram_update_ref(K1, M, Z, Xt, lam, gu_vs),
        16 * d * 4 + 16 * d * es + 64 * d * 4 + (2 if lanes else 1)
        * lane_bytes + 4 * 2 * 64 * 16,
        4 * 64 * 16 * d + 2 * 64 * d, None, None))
    for stationary in (True, False):
        out.append((
            "fused_gram_mvm", ("stationary" if stationary else "dot") + tag,
            lambda s=stationary: ops.fused_gram_mvm(
                K1e, K2e, Xt, Z, lam, stationary=s, noise=NOISE),
            lambda s=stationary: ref.fused_gram_mvm_ref(
                K1e, K2e, Xt, Z, lam, stationary=s, noise=NOISE),
            16 * d * es + 16 * d * 4 + 16 * d * 4 + lane_bytes
            + 8 * 16 * 16,
            6 * 16 * 16 * d + 5 * 16 * d, None,
            None if split is None else lambda s=stationary: split(
                K1e, K2e, Xt, Z, lam, stationary=s, noise=NOISE)))
    # B4/B5 at the query shape and with the same tensor as A and B, as
    # build_factors(X, X) calls them: the bound reads that tensor once, as
    # the symmetric mode does; B4 also at infer_optimum's single query
    for label, A, B in (("query (64,16)", Xq, Xt), ("A=B (16,16)", Xt, Xt),
                        ("(1,16)", x, Xt)):
        na, nb = A.shape[0], B.shape[0]
        rows_read = na if A is B else na + nb
        P_out = torch.empty(na, nb, device="cuda")
        out.append((
            "fused_gram_norms", label + tag,
            lambda A=A, B=B: ops.fused_gram_norms(A, B, lam),
            lambda A=A, B=B: ref.fused_gram_norms_ref(A, B, lam),
            rows_read * d * es + lane_bytes + 4 * (na * nb + na + nb),
            2 * na * nb * d + 3 * (na + nb) * d, None, None))
        if na == 1:
            continue
        out.append((
            "skinny_gram", label + tag,
            lambda A=A, B=B: ops.skinny_gram(A, B, lam),
            lambda A=A, B=B: ref.skinny_gram_ref(A, B, lam),
            rows_read * d * es + lane_bytes + 4 * na * nb,
            2 * na * nb * d + na * d,
            (lambda A=A, B=B, P_out=P_out: torch.addmm(
                P_out, A, B.T, beta=0, alpha=1.0 / d)) if library else None,
            None))
    W_out = torch.empty(16, d, device="cuda")
    out.append((
        "small_matmul", "(16,16)x(16,D)" + tag,
        lambda: ops.small_matmul(K1e, Xt, vs),
        lambda: ref.small_matmul_ref(K1e, Xt, vs),
        16 * d * es + 16 * d * 4 + lane_bytes + 4 * 16 * 16,
        2 * 16 * 16 * d + 16 * d,
        (lambda: torch.addmm(W_out, K1e, Xt, beta=0, alpha=1.0 / d))
        if library else None, None))
    for stationary in (True, False):
        out.append((
            "fused_gram_mvm_multi",
            f"R={R_STACK} " + ("stationary" if stationary else "dot") + tag,
            lambda s=stationary: ops.fused_gram_mvm(
                K1e, K2e, Xt, Vm, lam, stationary=s, noise=NOISE),
            lambda s=stationary: ref.fused_gram_mvm_ref(
                K1e, K2e, Xt, Vm, lam, stationary=s, noise=NOISE),
            16 * d * es + 2 * R_STACK * 16 * d * 4 + lane_bytes
            + 8 * 16 * 16,
            R_STACK * (6 * 16 * 16 * d + 5 * 16 * d), None,
            None if split is None else lambda s=stationary: split(
                K1e, K2e, Xt, Vm, lam, stationary=s, noise=NOISE)))
    return out


def phase_kernels(torch, detail):
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, main = [], {}
    cases = [(d, bf16, lanes) for d in (D_PATH, D_RAGGED)
             for lanes in ((False,) if d == D_PATH else (False, True))
             for bf16 in (False, True)]
    for d, bf16, lanes in cases:
        for name, label, kern, plain, nbytes, flops, lib, phases in \
                kernel_cases(torch, d, bf16, lanes, gen):
            got = kern()
            again = kern()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(
                got if isinstance(got, tuple) else (got,),
                again if isinstance(again, tuple) else (again,)))
            if not same:
                raise SystemExit(f"{name} {label} D={d}: two launches on "
                                 f"the same inputs differ")
            del again
            rel, absolute = rel_err(got, plain())
            row = {"kernel": name, "case": label, "d": d,
                   "streams": "bf16" if bf16 else "f32",
                   "lam": "(D,)" if lanes else "scalar",
                   "rel_err": rel, "max_abs_err": absolute,
                   "tol": KERNEL_TOL}
            if d == D_PATH:
                row["ms"] = time_ms(torch, kern)
                row["plain_ms"] = time_ms(torch, plain)
                row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
                row["library_ms"] = None if lib is None else time_ms(torch,
                                                                     lib)
                if phases is not None:
                    row["phase_ms"] = {what: time_ms(torch, fn)
                                       for what, fn in phases()}
            rows.append(row)
            print(f"  {name:20s} {label:24s} D={d:<8d} "
                  f"{row['streams']:4s} rel {rel:.2e} (tol {KERNEL_TOL:g})"
                  + (f"  {row['ms']:.3f} ms, plain {row['plain_ms']:.3f}"
                     f" ms, bound {row['bound_ms']:.3f} ms"
                     if "ms" in row else "")
                  + (f", library {row['library_ms']:.3f} ms"
                     if row.get("library_ms") is not None else "")
                  + ("".join(f"; {what} {t:.3f} ms" for what, t in
                             row["phase_ms"].items())
                     if "phase_ms" in row else ""))
            if not rel <= KERNEL_TOL:
                raise SystemExit(f"{name} {label} D={d} disagrees with "
                                 f"its plain version: {rel:.3e}")
            if d == D_PATH and not bf16 and name not in main:
                main[name] = row
            del got
        torch.cuda.empty_cache()
    detail["kernels"] = rows
    return main


# ---------------------------------------------------------------------------
# Phase 4: the main path, and an independent float64 plain run
# ---------------------------------------------------------------------------

def test_function_grad(torch, x):
    """Gradient of the README's f(x) = sum(sin(x) * roll(x, 1)) / D."""
    return (torch.cos(x) * torch.roll(x, 1) +
            torch.roll(torch.sin(x), -1)) / x.shape[-1]


def plain_pcg(torch, spec, X, G, z0, lam, noise, *, steps=None,
              tol=None, jitter=1e-10):
    """Solve the gradient Gram system of the window (X, G) at the dtype of
    X: factors from one plain fused_factor_build, the Cholesky of K1n from
    scratch, then PCG from z0 with the plain Gram MVM and the Kronecker
    preconditioner, for ``steps`` steps or until ||r|| <= tol ||G||.
    Returns (Z, ||r|| / ||G||)."""
    from repro_torch.kernels import ref

    n = X.shape[0]
    P, na, nb, _, _ = ref.fused_factor_build_ref(X, X, None, lam)
    r = torch.clamp_min(na[:, None] + nb[None, :] - 2.0 * P, 0.0)
    K1e, K2e = spec.k1e(r), spec.k2e(r)
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    L = torch.linalg.cholesky(K1e + (noise / lam + jitter) * eye)

    def mv(V):
        return ref.fused_gram_mvm_ref(K1e, K2e, X, V, lam, stationary=True,
                                      noise=noise)

    def dot(a, b):
        return float(torch.vdot(a.reshape(-1), b.reshape(-1)))

    gnorm = math.sqrt(dot(G, G))
    z = z0
    res = G - mv(z)
    s = torch.cholesky_solve(res, L) / lam
    p, rz = s, dot(res, s)
    for _ in range(steps if steps is not None else 1000):
        if tol is not None and math.sqrt(dot(res, res)) <= tol * gnorm:
            break
        Ap = mv(p)
        alpha = rz / dot(p, Ap)
        z = z + alpha * p
        res = res - alpha * Ap
        s = torch.cholesky_solve(res, L) / lam
        rz, rz_old = dot(res, s), rz
        p = s + (rz / rz_old) * p
    return z, math.sqrt(dot(res, res)) / gnorm


def plain_trajectory(torch, spec, xs, gs, iters, lam):
    """Z after every extend from an independent float64 run of the same
    method on the same inputs: the window slides as the state's does, and
    each solve starts from the previous Z (oldest row dropped, new row
    zero) and takes as many CG steps as the port took, so both truncate
    alike and what differs is the arithmetic."""
    zs, rels, z = [], [], None
    for i, steps in enumerate(iters):
        lo = max(0, i + 1 - WINDOW)
        X = torch.stack(xs[lo:i + 1]).double()
        G = torch.stack(gs[lo:i + 1]).double()
        if z is None:
            z0 = torch.zeros_like(G)
        else:
            keep = z[1:] if i >= WINDOW else z
            z0 = torch.cat([keep, torch.zeros_like(G[:1])])
        z, rel = plain_pcg(torch, spec, X, G, z0, lam, NOISE, steps=steps)
        zs.append(z)
        rels.append(rel)
    return zs, rels


def plain_posterior(torch, spec, Xq, X, Z, lam):
    """Posterior mean value and grad at Xq of the rbf window (X, Z)."""
    from repro_torch.kernels import ref

    P, naq, nbd, C, tz = ref.fused_factor_build_ref(Xq, X, Z, lam, lam)
    r = torch.clamp_min(naq[:, None] + nbd[None, :] - 2.0 * P, 0.0)
    m = C.T - tz[None, :]
    value = torch.sum(-2.0 * spec.k1(r) * m, dim=1)
    Mt = spec.k2e(r) * m
    grad = ref.gram_update_ref(spec.k1e(r), -Mt, Z, X, lam)
    return value, grad + (Xq * torch.sum(Mt, dim=1)[:, None]) * lam


def phase_main_path(torch, detail):
    from repro_torch import GPGState, GPServeConfig, build_gp_serve_step
    from repro_torch.kernels import ops, ref

    d = D_PATH
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(d, generator=gen, device="cuda")]
    for _ in range(N_OBS - 1):
        xs.append(xs[-1] + torch.randn(d, generator=gen, device="cuda"))
    gs = [test_function_grad(torch, x) for x in xs]
    queries = [xs[-1][None] + 0.1 * torch.randn(QUERIES, d, generator=gen,
                                                device="cuda")
               for _ in range(REQUESTS)]
    torch.cuda.synchronize()

    st = GPGState("rbf", d=d, window=WINDOW, lam=1.0 / d, noise=NOISE,
                  tol=CG_TOL, device="cuda")
    serve = build_gp_serve_step(st, config=GPServeConfig(tol=CG_TOL),
                                device="cuda")
    ops.reset_launches()
    plain_before = dict(ref.cuda_calls)
    torch.cuda.reset_peak_memory_stats()
    steps, z_seen = [], []
    t_path = time.monotonic()
    for i, (x, g) in enumerate(zip(xs, gs)):
        t0 = time.monotonic()
        st.extend(x, g)
        torch.cuda.synchronize()
        steps.append({"extend": i, "n": st.n, "cg_iters": st.stats["cg_iters"],
                      "resnorm": st.stats["resnorm"],
                      "ms": (time.monotonic() - t0) * 1e3})
        z_seen.append(st.Z.clone())
        print(f"  extend {i:2d}: n={st.n:2d} cg_iters={steps[-1]['cg_iters']:3d}"
              f" resnorm={steps[-1]['resnorm']:.3e} {steps[-1]['ms']:.1f} ms")
    answers, request_ms = [], []
    for Xq in queries:
        t0 = time.monotonic()
        answers.append(serve.query(Xq))
        torch.cuda.synchronize()
        request_ms.append((time.monotonic() - t0) * 1e3)
    wall = time.monotonic() - t_path
    launches = dict(ops.launches)
    plain_on_cuda = {k: ref.cuda_calls[k] - plain_before[k]
                     for k in ref.cuda_calls}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  requests: {', '.join(f'{t:.1f}' for t in request_ms)} ms;"
          f" main path wall {wall:.2f} s; peak memory {peak_gb:.1f} GB")
    print(f"  launches {launches}; plain versions on CUDA tensors "
          f"{plain_on_cuda}")
    if min(launches[k] for k in PATH4_KERNELS) <= 0:
        raise SystemExit(f"a kernel of the path never launched: {launches}")
    if any(plain_on_cuda.values()):
        raise SystemExit(f"plain versions ran on the card: {plain_on_cuda}")
    if st.n != WINDOW or st.stats["n_solve"] != N_OBS:
        raise SystemExit(f"unexpected state after the path: {st.stats}")

    # float64 plain run of the same method on the same inputs
    spec, lam = st.spec, 1.0 / d
    z_ref, ref_rel = plain_trajectory(torch, spec, xs, gs,
                                      [s_["cg_iters"] for s_ in steps], lam)
    worst_z, worst_res = 0.0, max(ref_rel)
    for i, (zp, zr) in enumerate(zip(z_seen, z_ref)):
        err = float(torch.linalg.norm(zp.double() - zr) /
                    torch.linalg.norm(zr))
        steps[i]["z_rel_err"] = err
        steps[i]["plain_rel_residual"] = ref_rel[i]
        worst_z = max(worst_z, err)
    z_last = z_seen[-1]
    del z_seen
    X = torch.stack(xs[N_OBS - WINDOW:]).double()
    G = torch.stack(gs[N_OBS - WINDOW:]).double()
    # the exact answer (CG to 1e-12) shows what stopping at CG_TOL costs
    z_exact, _ = plain_pcg(torch, spec, X, G, torch.zeros_like(G), lam,
                           NOISE, tol=1e-12)
    worst_v = worst_g = exact_v = exact_g = 0.0
    for Xq, pb in zip(queries, answers):
        if pb.value.shape != (QUERIES,) or pb.grad.shape != (QUERIES, d) \
                or not bool(torch.isfinite(pb.grad).all()):
            raise SystemExit("serve step returned a malformed answer")
        for z, worst in ((z_ref[-1], "plain"), (z_exact, "exact")):
            v_ref, g_ref = plain_posterior(torch, spec, Xq.double(), X, z,
                                           lam)
            ev = float((pb.value.double() - v_ref).abs().max() /
                       v_ref.abs().max())
            eg = float(torch.linalg.norm(pb.grad.double() - g_ref) /
                       torch.linalg.norm(g_ref))
            if worst == "plain":
                worst_v, worst_g = max(worst_v, ev), max(worst_g, eg)
            else:
                exact_v, exact_g = max(exact_v, ev), max(exact_g, eg)
    exact_z = float(torch.linalg.norm(z_last.double() - z_exact) /
                    torch.linalg.norm(z_exact))
    print(f"  float64 plain run at the port's CG step counts: residual "
          f"{worst_res:.2e} at worst (tol {CG_TOL:g})")
    print(f"  vs float64 plain run: Z {worst_z:.2e}, value {worst_v:.2e}, "
          f"grad {worst_g:.2e} (tol {PATH_TOL:g})")
    print(f"  vs the exact solve (CG to 1e-12, not gated): Z {exact_z:.2e}, "
          f"value {exact_v:.2e}, grad {exact_g:.2e}")
    detail["main_path"] = {
        "d": d, "window": WINDOW, "observations": N_OBS,
        "requests": REQUESTS, "queries": QUERIES, "cg_tol": CG_TOL,
        "steps": steps, "request_ms": request_ms, "wall_s": wall,
        "launches": launches, "plain_on_cuda": plain_on_cuda,
        "peak_memory_gb": peak_gb, "plain_rel_residual": worst_res,
        "z_rel_err": worst_z,
        "value_rel_err": worst_v, "grad_rel_err": worst_g, "tol": PATH_TOL,
        "vs_exact": {"z_rel_err": exact_z, "value_rel_err": exact_v,
                     "grad_rel_err": exact_g}}
    short = [i for i, rel in enumerate(ref_rel) if not rel <= CG_TOL]
    if short:
        raise SystemExit(f"the port's CG step counts leave the float64 "
                         f"residual above {CG_TOL:g} after extends {short}")
    if not max(worst_z, worst_v, worst_g) <= PATH_TOL:
        raise SystemExit("the port disagrees with the float64 plain run")
    ctx = {"launches": launches, "state": st, "z_window": z_last,
           "X": X.float(), "G": G.float(), "Xq": queries[0]}
    del X, G
    detail["profile"] = profile_calls(torch, (
        ("extend", lambda: st.extend(xs[-1] + 1.0, gs[-1])),
        ("request", lambda: serve.query(queries[0]))))
    return ctx


def profile_calls(torch, calls):
    """Where the time goes: torch.profiler over each (name, call) after the
    checked run. Device busy time is the sum of the device time of every
    kernel and copy; the rest of the host wall time is device idle."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for what, fn in calls:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
        rows = []
        for ev in prof.key_averages():
            # device-side entries only (kernels and copies): a CPU op's
            # entry repeats the device time of the kernels it launched
            if "CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            dev = getattr(ev, "self_device_time_total", None)
            if dev is None:
                dev = getattr(ev, "self_cuda_time_total", 0.0)
            if dev > 0:
                rows.append((ev.key, dev, ev.count))
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        out[what] = {"wall_us": wall_us, "device_busy_us": busy,
                     "idle_share": 1.0 - busy / wall_us,
                     "top": [{"name": k[:90], "device_us": t, "count": c}
                             for k, t, c in rows[:10]]}
        print(f"  {what}: wall {wall_us / 1e3:.2f} ms, device busy "
              f"{busy / 1e3:.2f} ms (idle {1 - busy / wall_us:.0%})")
        for k, t, c in rows[:6]:
            print(f"    {t / 1e3:8.3f} ms  x{c:<4d} {k[:70]}")
    return out

# ---------------------------------------------------------------------------
# Phase 5: the batch path, and the port's float64 run on the CPU
# ---------------------------------------------------------------------------

def batch_inputs(torch, ctx, gen):
    """Phase 5's inputs on the card: phase 4's last window (X, G) and
    first query batch, R_STACK - 1 seeded blocks scaled to G's norm, the
    poly2 quadratic f(x) = 1/2 (x - x*)^T A (x - x*) with a log-uniform
    diagonal A in [0.5, 100] at 16 seeded points, and a seeded probe."""
    X, G = ctx["X"], ctx["G"]
    d = X.shape[1]
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    gnorm = torch.linalg.norm(G)
    blocks = [rnd(*G.shape) for _ in range(R_STACK - 1)]
    Gs = torch.stack([G] + [b * (gnorm / torch.linalg.norm(b))
                            for b in blocks])
    u = torch.rand(d, generator=gen, device="cuda")
    A = torch.exp(math.log(0.5) + u * (math.log(100.0) - math.log(0.5)))
    x_star = rnd(d)
    Xp = rnd(WINDOW, d)
    return {"X": X, "G": G, "Xq": ctx["Xq"], "Gs": Gs, "A": A,
            "x_star": x_star, "Xp": Xp, "Gp": (Xp - x_star) * A,
            "g_c": -A * x_star, "v": rnd(d)}


def run_batch(torch, inp, state, *, iterative):
    """Phase 5's calls of the port on the device and dtype of ``inp``.

    Returns (results, wall ms of each step, CG iterations). With
    ``iterative=False`` (the float64 reference) the CG solves are replaced
    by the exact Woodbury solve of each right-hand side, and bulk
    conditioning is left out.
    """
    from repro_torch import (GPGState, build_factor_bundle, build_factors,
                             get_kernel, gram_cg_solve, gram_cg_solve_multi,
                             poly2_quadratic_solve, posterior_grad,
                             posterior_value, woodbury_solve)
    from repro_torch.optim import auto_lengthscale, gph_direction, \
        gpx_direction

    X, G, Xq = inp["X"], inp["G"], inp["Xq"]
    dev, d = X.device, X.shape[1]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    spec, lam = get_kernel("rbf"), 1.0 / d
    out, ms, iters = {}, {}, {}

    def step(name, fn):
        sync()
        t0 = time.monotonic()
        res = fn()
        sync()
        ms[name] = (time.monotonic() - t0) * 1e3
        return res

    def exact():
        b = build_factor_bundle(spec, X, G, lam=lam, noise=NOISE)
        return b, woodbury_solve(spec, b.factors, G, bundle=b)

    b, out["Z_w"] = step("a_woodbury", exact)
    f = b.factors
    if iterative:
        st = step("b_from_data", lambda: GPGState.from_data(
            "rbf", X, G, window=WINDOW, lam=lam, noise=NOISE,
            tol=BATCH_CG_TOL, maxiter=BATCH_MAXITER, dtype=X.dtype,
            device=dev))
        out["Z_b"], iters["b_from_data"] = st.Z, st.stats["cg_iters"]
        res = step("c_cg", lambda: gram_cg_solve(
            spec, f, G, tol=BATCH_CG_TOL, maxiter=BATCH_MAXITER))
        out["Z_c"], iters["c_cg"] = res.x, res.iters
        res = step("d_cg_multi", lambda: gram_cg_solve_multi(
            spec, f, inp["Gs"], tol=BATCH_CG_TOL, maxiter=BATCH_MAXITER))
        out["Z_d"], iters["d_cg_multi"] = res.x, res.iters
    else:
        out["Z_c"] = out["Z_w"]
        out["Z_d"] = step("d_woodbury_each", lambda: torch.stack([
            woodbury_solve(spec, f, Gr) for Gr in inp["Gs"]]))
    out["value"] = step("e_value", lambda: posterior_value(
        spec, Xq, f, out["Z_w"]))
    out["grad"] = step("e_grad", lambda: posterior_grad(
        spec, Xq, f, out["Z_w"]))
    x_t = Xq[0]
    g_t = test_function_grad(torch, x_t)
    out["gph"] = step("f_gph", lambda: gph_direction(
        X, G, x_t, g_t, kernel="rbf", lam=lam, noise=NOISE))
    out["gpx"] = step("f_gpx", lambda: gpx_direction(
        X, G, x_t, kernel="rbf", lam=auto_lengthscale(G)))

    def poly2():
        fp = build_factors(get_kernel("poly2"), inp["Xp"], lam=lam)
        return poly2_quadratic_solve(fp, inp["Gp"], g_c=inp["g_c"])

    out["Z_p"] = step("g_poly2", poly2)
    pb = step("h_probe", lambda: state.posterior(Xq[:PROBE_QUERIES],
                                                 probe=inp["v"]))
    out["probe_value"], out["probe_grad"] = pb.value, pb.grad
    out["hess_v"] = pb.hess_v
    return out, ms, iters


def cpu_state_copy(torch, st):
    """Phase 4's state on the CPU in float64, through the converters."""
    from repro_torch import convert

    return convert.state_from_numpy(
        convert.data_to_numpy(st.data), kernel=st.spec.name,
        window=st.window, noise=st.noise, signal=st.signal,
        jitter=st.jitter, deg_thresh=st.deg_thresh, tol=st.tol,
        maxiter=st.maxiter, device="cpu", dtype=torch.float64)


# (card result, float64 result it is held against); Z_b is the bulk-
# conditioned state's CG solve, held against the exact solve.
BATCH_PAIRS = (("Z_w", "Z_w"), ("Z_b", "Z_w"), ("Z_c", "Z_c"), ("Z_d", "Z_d"),
               ("value", "value"), ("grad", "grad"), ("gph", "gph"),
               ("gpx", "gpx"), ("Z_p", "Z_p"), ("probe_value", "probe_value"),
               ("probe_grad", "probe_grad"), ("hess_v", "hess_v"))


def batch_errors(torch, got, want):
    """Relative error of each card result against the float64 run: in
    norm (for a stack, the worst slab), and max-abs for the posterior
    values, as in phase 4."""
    errs = {}
    for gk, wk in BATCH_PAIRS:
        g, w = got[gk].double().cpu(), want[wk]
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise SystemExit(f"phase 5: {gk} is malformed: shape "
                             f"{tuple(g.shape)}, want {tuple(w.shape)}")
        if gk in ("value", "probe_value"):
            errs[gk] = float((g - w).abs().max() / w.abs().max())
        else:
            g, w = g.reshape(-1, *w.shape[-2:]), w.reshape(-1, *w.shape[-2:])
            errs[gk] = max(float(torch.linalg.norm(g[r] - w[r]) /
                                 torch.linalg.norm(w[r]))
                           for r in range(w.shape[0]))
    return errs


def phase_batch(torch, detail, ctx):
    from repro_torch.core import get_kernel, gram_cg_solve, woodbury_solve
    from repro_torch.core.gram import build_factors
    from repro_torch.kernels import ops, ref

    t_phase = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(5)
    inp = batch_inputs(torch, ctx, gen)
    torch.cuda.synchronize()
    ops.reset_launches()
    plain_before = dict(ref.cuda_calls)
    torch.cuda.reset_peak_memory_stats()
    got, ms, iters = run_batch(torch, inp, ctx["state"], iterative=True)
    launches = dict(ops.launches)
    plain_on_cuda = {k: ref.cuda_calls[k] - plain_before[k]
                     for k in ref.cuda_calls}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    card_s = sum(ms.values()) / 1e3
    for name, t in ms.items():
        print(f"  {name:16s} {t:9.1f} ms"
              + (f"  cg_iters {iters[name]}" if name in iters else ""))
    print(f"  launches {launches}; plain versions on CUDA tensors "
          f"{plain_on_cuda}; peak memory {peak_gb:.1f} GB")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the batch path never launched: "
                         f"{launches}")
    if any(plain_on_cuda.values()):
        raise SystemExit(f"plain versions ran on the card: {plain_on_cuda}")
    over = [k for k, n in iters.items() if n >= BATCH_MAXITER]
    if over:
        raise SystemExit(f"CG used its whole budget in {over}: {iters}")

    t0 = time.monotonic()
    cpu = {k: v.double().cpu() for k, v in inp.items()}
    want, ref_ms, _ = run_batch(torch, cpu, cpu_state_copy(torch,
                                                           ctx["state"]),
                                iterative=False)
    ref_s = time.monotonic() - t0
    errs = batch_errors(torch, got, want)
    errs["Z_b_vs_Z_w"] = float(torch.linalg.norm(got["Z_b"] - got["Z_w"]) /
                               torch.linalg.norm(got["Z_w"]))
    zw = want["Z_w"]
    z_stream = float(torch.linalg.norm(ctx["z_window"].double().cpu() - zw)
                     / torch.linalg.norm(zw))
    for k, e in errs.items():
        print(f"  {k:14s} rel err {e:.2e} (tol {PATH_TOL:g})")
    print(f"  phase 4's streaming Z (CG to {CG_TOL:g}) vs the float64 "
          f"Woodbury Z of the same window: {z_stream:.2e} (not gated)")
    print(f"  float64 reference on the CPU: {ref_s:.1f} s")
    bad = {k: e for k, e in errs.items() if not e <= PATH_TOL}

    f = build_factors(get_kernel("rbf"), inp["X"], lam=1.0 / inp["X"].shape[1],
                      noise=NOISE)
    spec, G = get_kernel("rbf"), inp["G"]
    profile = profile_calls(torch, (
        ("woodbury_solve", lambda: woodbury_solve(spec, f, G)),
        ("gram_cg_solve", lambda: gram_cg_solve(
            spec, f, G, tol=BATCH_CG_TOL, maxiter=BATCH_MAXITER))))
    wall = time.monotonic() - t_phase
    print(f"  phase 5 wall {wall:.1f} s (card steps {card_s:.2f} s)")
    detail["batch_path"] = {
        "d": inp["X"].shape[1], "n": WINDOW, "r_stack": R_STACK,
        "queries": inp["Xq"].shape[0], "cg_tol": BATCH_CG_TOL,
        "step_ms": ms, "cg_iters": iters, "launches": launches,
        "plain_on_cuda": plain_on_cuda, "peak_memory_gb": peak_gb,
        "rel_err": errs, "tol": PATH_TOL, "z_stream_vs_woodbury": z_stream,
        "reference_s": ref_s, "reference_step_ms": ref_ms,
        "profile": profile, "wall_s": wall}
    if bad:
        raise SystemExit(f"phase 5 disagrees with the float64 run: {bad}")
    return launches


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the detailed numbers here as JSON")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory to import and build repro_torch "
                         "from (default: this checkout's src)")
    args = ap.parse_args(argv)
    out = args.out
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    detail = {}

    print("phase 1: the card")
    card = card_line()
    print(card)
    cap = torch.cuda.get_device_capability(0)
    detail["card"] = card
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"capability {cap}")
    if cap != (9, 0):
        raise SystemExit(f"needs an sm_90 card, found capability {cap}")

    print("phase 2: build")
    print(f"  port from {args.src.resolve()}")
    seconds = _build.build()
    detail["build_s"] = seconds
    print(f"  built {len(_build.SIGNATURES)} kernel libraries in "
          f"{seconds:.1f} s")
    for name in _build.SIGNATURES:
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in _build.build_log(name).splitlines()
                       if "Used " in line})
        print(f"  {name}: {'; '.join(regs)}")

    print("phase 3: kernels against their plain versions")
    main_rows = phase_kernels(torch, detail)

    print("phase 4: the main path")
    ctx = phase_main_path(torch, detail)

    print("phase 5: the batch path")
    batch_launches = phase_batch(torch, detail, ctx)
    launches = {k: ctx["launches"][k] + batch_launches[k]
                for k in batch_launches}

    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(detail, indent=1))
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/"
                  f"{SOURCE.get(name, name)}.cu",
        "replaces": REPLACES[name],
        "launches": launches[name],
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    } for name, row in main_rows.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
