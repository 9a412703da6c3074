"""Port: package isolation and device resolution.

csbsr_tpu_torch and chip_smoke.py import no JAX, Flax, Orbax or anything of
the JAX package, nor OpenCV or torchvision (the card's machine has neither);
the package imports with `jax` blocked; entry points refuse
to fall back to the CPU when CUDA is asked for (or implied) and absent.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "csbsr_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "csbsr_tpu",
             "cv2", "torchvision")  # the last two: absent from the card's machine


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_package_imports_with_jax_blocked():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "csbsr_tpu_torch").rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'orbax', 'csbsr_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax') and sys.modules[k] is not None\n"
        "               for k in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_from_cfg_without_device_raises_when_cuda_is_absent(monkeypatch):
    from csbsr_tpu_torch.config import get_cfg_defaults
    from csbsr_tpu_torch.models import model_from_cfg

    _no_cuda(monkeypatch)
    cfg = get_cfg_defaults()
    cfg.MODEL.SR, cfg.MODEL.DETECTOR_TYPE = "KBPN", "PSPNet"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model_from_cfg(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model_from_cfg(cfg, device="cuda")


def test_cli_default_device_raises_when_cuda_is_absent(monkeypatch, tmp_path):
    from csbsr_tpu_torch.test import main

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(tmp_path), "1"])


def test_chip_smoke_refuses_without_cuda_or_the_repo(tmp_path):
    """No result line without CUDA; none either from a directory that holds
    chip_smoke.py alone (even with CUDA reported present)."""
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    if not torch.cuda.is_available():
        assert res.returncode != 0 and '"ok"' not in res.stdout
    code = ("import torch, runpy, sys\n"
            "torch.cuda.is_available = lambda: True\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=alone, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    assert "csbsr_tpu_torch" in res.stderr
