"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

``repro_torch`` (every module of it) and ``chip_smoke`` (as a module: its
phases run only under ``__main__``) are imported in a fresh interpreter,
which must then hold no ``jax*`` and no ``repro``/``repro.*`` module. And an
entry point given no device runs on CUDA or raises; it never carries on on
the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
print(json.dumps(sorted(sys.modules)))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = __import__("json").loads(out.stdout.splitlines()[-1])
    assert "repro_torch.core.state" in mods and "chip_smoke" in mods
    bad = [m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_entry_points_without_device_do_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch import GPGState, build_gp_serve_step, gpg_init
    from repro_torch import convert
    from repro_torch.core import get_kernel

    with pytest.raises(RuntimeError, match="CUDA"):
        GPGState("rbf", d=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPGState.from_data("rbf", torch.zeros(2, 8), torch.zeros(2, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        gpg_init(get_kernel("rbf"), 8, 4)
    st = GPGState("rbf", d=8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_gp_serve_step(st)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.data_from_numpy({})
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.factors_from_numpy({})


def test_chip_smoke_alone_fails_without_printing_a_result(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
