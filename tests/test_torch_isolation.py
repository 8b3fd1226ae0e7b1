"""The port stands alone: no jax, nothing of repro, no silent CPU runs."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in _imported_modules(path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.mark.parametrize("modules", [
    "repro_torch.serving.engine, repro_torch.convert",
    "repro_torch.core.simulator, repro_torch.explore, "
    "repro_torch.launch.simulate",
    "repro_torch.training, repro_torch.launch.train, "
    "repro_torch.examples.train_100m",
    "repro_torch.distributed.api, repro_torch.distributed.shard_plan, "
    "repro_torch.launch.mesh",
    "repro_torch.examples.serve_smoke",
    "repro_torch.examples.quickstart, repro_torch.examples.multi_tenant, "
    "repro_torch.examples.disaggregated_serving, "
    "repro_torch.examples.speculative, repro_torch.examples.observability",
])
def test_engine_import_loads_no_jax(modules):
    """Importing the serving engine, the simulator and its entry points,
    the trainer and its entry points, the sharding plan and its meshes,
    the serve-then-simulate example or the simulator-only examples,
    loads nothing of jax or of the reference."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys, {modules}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = zoo.build(get_smoke_config("llama2-7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.init_params(model, seed=0)
    params = zoo.init_params(model, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, params, EngineConfig())


def test_serve_cli_refuses_cpu_fallback(monkeypatch):
    """``launch/serve.py`` runs on the card unless ``--device cpu``."""
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mamba2-130m", "--smoke", "--requests", "1"])


def test_train_entry_points_refuse_cpu_fallback(monkeypatch):
    """``Trainer``, ``launch/train.py`` and the 100M example run on the
    card unless ``device="cpu"`` / ``--device cpu``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import train_100m
    from repro_torch.launch import train
    from repro_torch.models import model_zoo as zoo
    from repro_torch.training import TrainConfig, Trainer
    from repro_torch.training.data import DataConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama2-7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(zoo.build(cfg), TrainConfig(),
                DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                           global_batch=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_100m.main(["--steps", "1"])
