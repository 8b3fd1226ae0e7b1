"""The port's ``launch/serve.py`` against the reference's, on the CPU.

For llama2-7b, opt-13b and the two granite MoE models on the paged path
and mamba2-130m, zamba2-2.7b and whisper-base on the slot path, ``python -m repro.launch.serve --smoke`` and the port's
``--smoke --device cpu`` with the same arguments must draw the same
request stream and report the same counts: finished requests,
preemption rate and engine iterations.  Walls and rates are host times
of two different programs and are not compared.  The weights differ
(each draws its own), which moves no count: requests stop at their
output length.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

ARGS = ["--smoke", "--requests", "10", "--num-blocks", "64",
        "--max-batch", "4"]
COUNTS = ("n_finished", "preempt_rate", "iterations")


def _recording(generate, into):
    def wrapped(spec):
        reqs = generate(spec)
        into.extend((r.id, r.prompt_len, r.output_len) for r in reqs)
        return reqs
    return wrapped


@pytest.mark.parametrize("arch", ["llama2-7b", "mamba2-130m", "opt-13b",
                                  "granite-moe-1b-a400m",
                                  "granite-moe-3b-a800m", "whisper-base",
                                  "zamba2-2.7b"])
def test_serve_matches_reference(arch, monkeypatch, capsys):
    argv = ["--arch", arch] + ARGS
    jstream, tstream = [], []
    monkeypatch.setattr(jserve, "generate", _recording(jserve.generate,
                                                       jstream))
    monkeypatch.setattr(tserve, "generate", _recording(tserve.generate,
                                                       tstream))
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    jserve.main()
    want = json.loads(capsys.readouterr().out)
    got = tserve.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got

    assert tstream == jstream and len(tstream) == 10
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["n_finished"] == 10
