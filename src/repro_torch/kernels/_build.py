"""Build the port's CUDA kernels from ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, one ``nvcc`` process per source,
all started together, at first use. Nothing includes PyTorch's headers, so
a build takes seconds. Libraries land in ``_build/`` beside this file,
named by a digest of the sources and flags, so an unchanged tree reuses
them. Only sources in the repository are compiled.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# source name -> (C entry point, its argument types); see csrc/<name>.cu.
SIGNATURES = {
    "fused_factor_build": ("ffb_launch", [
        _I, _I, _P, _P, _P, _P, _LL, _P, _LL, _I, _I, _I, _I, _LL, _P, _P,
        _P]),
    "gram_update": ("gu_launch", [
        _I, _I, _P, _P, _P, _P, _P, _LL, _P, _LL, _F, _I, _I, _LL, _P, _P]),
    "fused_gram_mvm": ("fgm_launch", [
        _I, _I, _P, _P, _P, _P, _P, _LL, _F, _I, _I, _I, _LL, _P, _P, _P,
        _I, _P]),
    "skinny_gram": ("sg_launch", [
        _I, _I, _P, _P, _P, _LL, _I, _I, _I, _LL, _P, _P, _P]),
    "fused_gram_norms": ("fgn_launch", [
        _I, _I, _P, _P, _P, _LL, _I, _I, _I, _LL, _P, _P, _P]),
    "small_matmul": ("sm_launch", [
        _I, _P, _P, _P, _LL, _I, _I, _LL, _P, _P]),
}
# Sources whose kernels reduce over D in two stages, all on the ring of
# csrc/skinny_stage.cuh (csrc/factor_stage.cuh adds the norms and full
# modes). Their libraries export its one split plan, which depends on the
# device's SM count (rt_split_plan), and the columns one ring holds for
# given operands (rt_stage_ring).
STAGE = ("fused_factor_build", "fused_gram_mvm", "skinny_gram",
         "fused_gram_norms")
# The flags of rt_stage_ring (csrc/common.cuh, RT_RING_*).
RING_SYM, RING_VEC_LAM, RING_V_IS_B, RING_VEC_VS = 1, 2, 4, 8

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's kernels are built "
            "from csrc/ with the CUDA toolkit at first use")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lands for this tree."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES)) -> float:
    """Compile every library of ``names`` not built yet; returns seconds.

    One ``nvcc`` per source, all running at once; waits for every one of
    them and raises with the compiler's log if any failed. The log of each
    build (with ``-Xptxas=-v`` register and spill counts) is kept beside
    its library.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    t0 = time.monotonic()
    jobs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        log_path = out.with_suffix(".log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, out, log_path))
    failed = []
    for name, proc, tmp, out, log_path in jobs:
        if proc.wait() != 0:
            failed.append(f"{name}:\n{log_path.read_text()[-4000:]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.monotonic() - t0


def build_log(name: str) -> str:
    """The compiler's output of the current build of ``name``."""
    return library_path(name).with_suffix(".log").read_text()


def launcher(name: str):
    """The C entry point of ``csrc/<name>.cu``, building all kernels first
    if this tree has not built them yet."""
    lib = _LIBS.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(library_path(name)))
        entry, argtypes = SIGNATURES[name]
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        if name in STAGE:
            lib.rt_split_plan.argtypes = [_LL, ctypes.POINTER(_LL)]
            lib.rt_split_plan.restype = ctypes.c_int
            lib.rt_stage_ring.argtypes = [_I] * 6
            lib.rt_stage_ring.restype = ctypes.c_int
        _LIBS[name] = lib
    return getattr(lib, SIGNATURES[name][0])


def split_plan(name: str, d: int) -> tuple[int, int]:
    """(CTAs, columns per CTA) of the first stage of a D-reduction, as the
    library of ``csrc/<name>.cu`` plans it on the current device."""
    launcher(name)
    chunk = _LL()
    ctas = _LIBS[name].rt_split_plan(d, ctypes.byref(chunk))
    return ctas, chunk.value


def stage_ring(name: str, a_code: int, b_code: int, na: int, nb: int, *,
               sym: bool = False, vec_lam: bool = False, v_code: int = 0,
               v_is_b: bool = False, vec_vs: bool = False) -> int:
    """Columns that one ring of the library's first stage holds (stages x
    tile width) for these operands on the current device; negative when no
    ring fits its shared memory (the launcher then refuses the shape). ``v_code``, ``v_is_b`` and ``vec_vs`` describe
    fused_factor_build's V and v_scale; the other libraries ignore them."""
    launcher(name)
    flags = (RING_SYM * sym | RING_VEC_LAM * vec_lam | RING_V_IS_B * v_is_b
             | RING_VEC_VS * vec_vs)
    return _LIBS[name].rt_stage_ring(a_code, b_code, v_code, na, nb, flags)


def error_string(name: str, code: int) -> str:
    return _LIBS[name].rt_error_string(code).decode()
