"""The port's five simulator-only examples
(``repro_torch.examples.<name>``) against the reference's
``examples/<name>.py``.

Each example runs in-process, the reference's module and then the
port's, in a fresh working directory, with stdout captured.  The two
outputs must be equal line for line, with only the wall-clock figure
(``in <seconds>s wall``) masked; ``observability`` must also write the
same ``results/obs/example_trace.json`` and
``results/obs/example_timeseries.csv``, byte for byte.  The simulator
is a pure function of its ``SimSpec``, so tolerance 0 holds.
"""
import importlib
import importlib.util
import pathlib
import re

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "multi_tenant", "disaggregated_serving",
            "speculative", "observability")
WALL = re.compile(r"in \d+\.\d+s wall")
OBS_FILES = ("example_trace.json", "example_timeseries.csv")


def _reference(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_ref_example_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(module, capsys, workdir, monkeypatch):
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    module.main()
    out = capsys.readouterr().out
    files = {f: (workdir / "results" / "obs" / f).read_bytes()
             for f in OBS_FILES if (workdir / "results" / "obs" / f).exists()}
    return WALL.sub("in <wall>s wall", out).splitlines(), files


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_matches_reference(name, capsys, tmp_path, monkeypatch):
    port = importlib.import_module(f"repro_torch.examples.{name}")
    ref_lines, ref_files = _run(_reference(name), capsys,
                                tmp_path / "reference", monkeypatch)
    port_lines, port_files = _run(port, capsys, tmp_path / "port",
                                  monkeypatch)
    assert len(ref_lines) > 3
    assert port_lines == ref_lines
    if name == "observability":
        assert sorted(ref_files) == sorted(OBS_FILES)
        assert port_files == ref_files
        assert port.build_spec() is not None
    else:
        assert port_files == ref_files == {}
