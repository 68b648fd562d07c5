"""The port stands on PyTorch alone, and fails loudly where it cannot run."""

import ast
import ctypes
import dataclasses
import inspect
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from edrl_tpu import config as jax_config
from edrl_tpu_torch import config as port_config
from edrl_tpu_torch.config import tiny_test_config
from edrl_tpu_torch.kernels import build

PACKAGE = Path(__file__).resolve().parents[1] / "edrl_tpu_torch"
CHIP_SMOKE = PACKAGE.parent / "chip_smoke.py"
# The JAX stack, the JAX package itself (even its JAX-free modules), and
# triton, which only a kernel launch may import.
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "edrl_tpu", "triton"}
CONFIG_CLASSES = ("NoiseConfig", "DataConfig", "ModelConfig", "TrainConfig", "EDRLConfig")


def test_import_loads_no_jax_or_triton():
    code = (
        "import importlib, pkgutil, sys\n"
        "import edrl_tpu_torch\n"
        "for m in pkgutil.walk_packages(edrl_tpu_torch.__path__, 'edrl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted({n.split('.')[0] for n in sys.modules} & {'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'triton', 'edrl_tpu'})\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        cwd=PACKAGE.parent, timeout=120,
    )
    assert out.stdout.strip() == ""


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax():
    """No module of the port and not chip_smoke.py imports JAX, triton, or
    anything of the JAX package (first dotted component ``edrl_tpu``)."""
    offenders = []
    for path in [*sorted(PACKAGE.rglob("*.py")), CHIP_SMOKE]:
        offenders += [f"{path.name}: {n}" for n in _imported_names(path) if n.split(".")[0] in FORBIDDEN]
    assert offenders == []


# The serving half of A10: int8, the chunk graph, export and the serving CLI.
SERVING_MODULES = ("edrl_tpu_torch.ops.quantization", "edrl_tpu_torch.serve.predictor",
                   "edrl_tpu_torch.serve.export", "edrl_tpu_torch.cli.predict")


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_modules_import_no_jax(module):
    """Neither the module's own imports nor what importing it loads include
    JAX, triton or the JAX package."""
    path = PACKAGE.parent / (module.replace(".", "/") + ".py")
    assert [n for n in _imported_names(path) if n.split(".")[0] in FORBIDDEN] == []
    code = (f"import sys, {module}\n"
            f"print(','.join(sorted({{n.split('.')[0] for n in sys.modules}} & set({sorted(FORBIDDEN)!r}))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=PACKAGE.parent, timeout=120)
    assert out.stdout.strip() == ""


# Data and tensor parallelism (A11): the package and the 4-card tool.
PARALLEL_MODULES = ("edrl_tpu_torch.parallel.__init__", "edrl_tpu_torch.parallel.mesh",
                    "edrl_tpu_torch.parallel.tensor", "edrl_tpu_torch.tools.profile_data_parallel")


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_modules_import_no_jax(module):
    """As the serving modules: no JAX, triton or JAX package, imported or
    loaded."""
    test_serving_modules_import_no_jax(module)


def test_make_mesh_refuses_a_model_axis_that_does_not_divide_the_world():
    """A world of one gloo process (no launcher): a model axis of 2 or 0
    raises ``ValueError``; a model axis of 1 gives the ``(1, 1)`` mesh with
    no model axis to shard over."""
    code = ("import torch.distributed as dist\n"
            "from edrl_tpu_torch import parallel\n"
            "from edrl_tpu_torch.parallel import mesh\n"
            "parallel.init_distributed('cpu')\n"
            "try:\n"
            "    for m in (2, 0):\n"
            "        try:\n"
            "            parallel.make_mesh(m, device='cpu')\n"
            "            print('accepted', m)\n"
            "        except ValueError as exc:\n"
            "            print('refused', exc)\n"
            "    one = parallel.make_mesh(1, device='cpu')\n"
            "    print(tuple(one.shape), mesh.model_axis_of(one), parallel.is_writer(one))\n"
            "finally:\n"
            "    dist.destroy_process_group()\n")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=PACKAGE.parent, timeout=120, env=env)
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "refused a model axis of 2 does not divide the world of 1 ranks"
    assert lines[1] == "refused a model axis of 0 does not divide the world of 1 ranks"
    assert lines[2] == "(1, 1) None True"


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_copy_matches_the_jax_package(name):
    """Same dataclasses, field names, order and defaults, so the copy cannot drift."""
    ours, theirs = getattr(port_config, name), getattr(jax_config, name)
    assert dataclasses.is_dataclass(ours)
    assert ours.__dataclass_params__.frozen == theirs.__dataclass_params__.frozen
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    mine, ref = ours(), theirs()
    for f in dataclasses.fields(ours):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("batch_size", [4, 3])
def test_tiny_test_config_copy_matches(batch_size):
    assert dataclasses.asdict(port_config.tiny_test_config(batch_size)) == dataclasses.asdict(
        jax_config.tiny_test_config(batch_size))


def test_entry_points_default_to_cuda():
    from edrl_tpu_torch.serve.predictor import Predictor
    from edrl_tpu_torch.train import trainer

    assert inspect.signature(Predictor.__init__).parameters["device"].default == "cuda"
    assert inspect.signature(trainer.init_state).parameters["device"].default == "cuda"


@pytest.mark.parametrize("module,name", [
    ("edrl_tpu_torch.train.mc_dropout", "mc_dropout_predict"),
    ("edrl_tpu_torch.train.robustness", "noise_sweep"),
    ("edrl_tpu_torch.train.ensemble", "ensemble_predict"),
    ("edrl_tpu_torch.train.ensemble", "evaluate_ensemble"),
    ("edrl_tpu_torch.train.ensemble", "restore_members"),
    ("edrl_tpu_torch.cli.ensemble", "run_ensemble"),
])
def test_evaluation_entry_points_default_to_cuda(module, name):
    import importlib

    fn = getattr(importlib.import_module(module), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_evaluation_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from edrl_tpu_torch.cli import ensemble as ensemble_cli
    from edrl_tpu_torch.serve.predictor import Predictor
    from edrl_tpu_torch.train import ensemble, mc_dropout, robustness, trainer

    cfg = tiny_test_config()
    state = trainer.init_state(cfg, device="cpu")
    for call in (lambda: mc_dropout.mc_dropout_predict(cfg, state, None),
                 lambda: robustness.noise_sweep(cfg, state),
                 lambda: ensemble.ensemble_predict(cfg, [state.model], None),
                 lambda: Predictor.from_checkpoints(cfg, [str(tmp_path)]),
                 lambda: ensemble_cli.main(["--skip_train", "--checkpoint_dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_trainer_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from edrl_tpu_torch.train import trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.init_state(tiny_test_config())


def test_serving_entry_points_default_to_cuda():
    from edrl_tpu_torch.cli import predict
    from edrl_tpu_torch.serve.predictor import Predictor

    assert predict.build_parser().parse_args([]).device == "cuda"
    assert inspect.signature(Predictor.__init__).parameters["device"].default == "cuda"


def test_serving_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from edrl_tpu_torch.cli import predict
    from edrl_tpu_torch.serve.predictor import Predictor

    for call in (lambda: Predictor(tiny_test_config(), quantize_int8=True),
                 lambda: Predictor(tiny_test_config(), chunk_batches=2),
                 lambda: predict.main(["--num", "2", "--int8", "--output", str(tmp_path / "p.csv")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "p.csv").exists()


def test_predictor_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from edrl_tpu_torch.serve.predictor import Predictor

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(tiny_test_config(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(tiny_test_config())


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
        "attention_common.cuh", "attention_fwd.cuh", "attention_bwd.cuh", "self_attention_fwd.cu",
        "window_attention_v2_fwd.cu", "self_attention_bwd.cu", "window_attention_v2_bwd.cu",
        "mmd_fwd.cu", "mma_common.cuh", "layer_norm.cuh", "layer_norm_fwd.cu", "layer_norm_bwd.cu",
        "fused_mlp.cuh", "fused_mlp_fwd.cu", "fused_mlp_bwd.cu",
    }


_ENTRY = re.compile(r'extern "C"\s+(int|long long)\s+(\w+)\s*\(([^)]*)\)\s*\{')
_CTYPE = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _c_entry_points(path: Path) -> dict:
    """``{name: (restype, argtypes)}`` of the ``extern "C"`` functions in a
    CUDA source, as ctypes types: a pointer parameter is ``c_void_p``."""
    found = {}
    for ret, name, params in _ENTRY.findall(path.read_text()):
        args = []
        for param in filter(None, (p.strip() for p in params.split(","))):
            decl = param.rsplit(None, 1)[0] if "*" not in param else "*"
            args.append(ctypes.c_void_p if "*" in decl else _CTYPE[decl.replace("const ", "")])
        found[name] = (_CTYPE[ret], args)
    return found


class _RecordingLibrary:
    """Stands in for the built library: records what ``build._bind`` sets."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, types.SimpleNamespace())


@pytest.mark.parametrize("source", sorted(p.name for p in build.CSRC.glob("*.cu")))
def test_entry_point_signatures_match_the_sources(source):
    """Every entry point a CUDA source exports is bound in build.py with its
    C parameters' ctypes types, in order: a mismatch would pass wrong
    arguments on the card, where no compiler sees both."""
    bound = build._bind(_RecordingLibrary()).fns
    entries = _c_entry_points(build.CSRC / source)
    assert entries, f"{source} exports no entry point"
    for name, (restype, argtypes) in entries.items():
        assert name in bound, f"{name} ({source}) is not bound in build.py"
        assert bound[name].restype is restype, name
        assert list(bound[name].argtypes) == argtypes, name


def test_every_bound_entry_point_is_in_a_source():
    bound = build._bind(_RecordingLibrary()).fns
    exported = {}
    for path in build.CSRC.glob("*.cu"):
        exported.update(_c_entry_points(path))
    assert set(bound) == set(exported)
