"""Package rules of the port: no JAX inside, the card unless asked."""

import ast
from pathlib import Path

import pytest
import torch

from swapnet_tpu_torch import resolve_device
from swapnet_tpu_torch.serving import build_fused_swap

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "swapnet_tpu")


def _port_sources():
    files = sorted((ROOT / "swapnet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and all(f.exists() for f in files)
    return files


def _forbidden_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            names = [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    offenders = {str(p.relative_to(ROOT)): b for p in _port_sources() if (b := _forbidden_imports(p))}
    assert offenders == {}


def test_import_guard_sees_an_offender(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom swapnet_tpu.ops import roi_align\nimport jax.numpy as jnp\n"
                 "from swapnet_tpu_torch import resolve_device\n")
    assert _forbidden_imports(f) == ["swapnet_tpu.ops", "jax.numpy"]


def test_resolve_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_point_raises_without_gpu_before_reading(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_fused_swap(str(tmp_path / "missing"), str(tmp_path / "missing"))
