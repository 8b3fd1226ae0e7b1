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
])
def test_engine_import_loads_no_jax(modules):
    """Importing the serving engine, or the simulator and its entry
    points, loads nothing of jax or of the reference."""
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
