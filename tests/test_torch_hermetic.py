"""The port stands on PyTorch alone, and fails loudly where it cannot run."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from edrl_tpu.config import tiny_test_config
from edrl_tpu_torch.kernels import build

PACKAGE = Path(__file__).resolve().parents[1] / "edrl_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax"}


def test_import_loads_no_jax_or_triton():
    code = (
        "import importlib, pkgutil, sys\n"
        "import edrl_tpu_torch\n"
        "for m in pkgutil.walk_packages(edrl_tpu_torch.__path__, 'edrl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted({n.split('.')[0] for n in sys.modules} & {'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'triton'})\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        cwd=PACKAGE.parent, timeout=120,
    )
    assert out.stdout.strip() == ""


def test_no_source_imports_jax():
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert offenders == []


def test_predictor_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from edrl_tpu_torch.serve.predictor import Predictor

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(tiny_test_config(), device="cuda")


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build_library(build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_source_hash_names_the_library():
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()
    assert {p.name for p in build._sources()} >= {
        "attention_fwd.cuh", "self_attention_fwd.cu", "window_attention_v2_fwd.cu",
    }
