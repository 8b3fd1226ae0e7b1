"""The port's training path against the reference's (``repro.training``,
``repro.models.model_zoo.loss_fn``, ``repro.launch.train``), on the CPU.

* ``softmax_xent`` with and without a mask (an all-zero mask too)
  equals the reference's to 1e-6.
* ``loss_fn``: its loss, its metrics (``xent``, and the MoE's ``aux`` and
  ``zloss``) and the gradient of every parameter equal
  ``jax.value_and_grad(zoo.loss_fn)`` on the same weights, for the smoke
  configs of llama2-7b, granite-moe-1b (aux and z-loss in the loss),
  mamba2-130m (S 32, a multiple of its chunk: ``ssd_chunked``; and S 24:
  the recurrence), zamba2-2.7b and whisper-base (with ``embeds``).  Each
  case runs on an fp32-compute copy of the config (loss to 1e-6,
  gradients to ``GRAD_TOL["float32"]``) and on the bf16 default
  (``GRAD_TOL["bfloat16"]``).  A gradient's error is taken against the
  larger of its own largest value and 1e-2 of the tree's largest
  gradient, since some gradients are zero but for rounding (a key bias
  shifts every score of a row alike).  The reference's results are made
  once per module (``reference_loss``).
* Each remat mode gives bit for bit ``none``'s loss and gradients, and
  ``full`` and ``dots_saveable`` do recompute every layer.
* ``schedule``, ``adamw_update``, ``quantize`` (ties round half to even)
  and ``compress_grads`` (error feedback over steps) equal the
  reference's on the same inputs; ``compress_grads`` over a process
  group of two (gloo) equals the reference's psum over a vmapped axis.
* Three ``Trainer`` steps from the reference's weights equal the
  reference's ``Trainer`` within its own 2e-4.
* The reference's ``test_training.py`` cases, on the port: loss
  decreases, microbatch equivalence, restart exact, a stray ``.tmp``
  ignored, ``run_with_restarts``.
* A checkpoint written by the reference's ``Trainer`` restores in the
  port's bit for bit, and the reverse; both packages write the same
  manifest for the same tree, bf16 leaves included.
* ``attend(impl="pallas")`` raises under grad in the port, and the
  reference's ``jax.grad`` through its flash kernel fails.
* The SSD scan's autograd function, its forward given, takes the plain
  version's gradients (with and without an initial state).
* ``python -m repro_torch.launch.train --smoke --device cpu`` runs, and
  the 100M example holds the reference's config and settings.
"""
import dataclasses
import functools
import importlib.util
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.models.attention_impl import attend as jax_attend  # noqa: E402
from repro.models.layers import softmax_xent as jax_xent  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import grad_compress as jgc  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.distributed.fault import (InjectedFailure,  # noqa: E402
                                           run_with_restarts)
from repro_torch.examples import train_100m  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models.attention_impl import attend  # noqa: E402
from repro_torch.models.common import RunSettings, tree_leaves  # noqa: E402
from repro_torch.models.layers import softmax_xent  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import grad_compress as tgc  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.data import DataConfig  # noqa: E402
from repro_torch.training.trainer import (TrainConfig, Trainer,  # noqa: E402
                                          value_and_grad)

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: (arch, sequence length): mamba2-130m at a multiple of its smoke chunk
#: (32: ssd_chunked) and not (24: the recurrence)
LOSS_CASES = [("llama2-7b", 16), ("granite-moe-1b-a400m", 16),
              ("mamba2-130m", 32), ("mamba2-130m", 24), ("zamba2-2.7b", 32),
              ("whisper-base", 16)]
DTYPES = ("float32", "bfloat16")
LOSS_TOL = {"float32": 1e-6, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
#: a gradient's error is measured against at least this share of the
#: tree's largest gradient
GRAD_FLOOR = 1e-2
BATCH = 2


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _np_tree(tree):
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                          np.float32) for k, v in _paths(tree)}


def _batch(cfg, s, seed=1):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (BATCH, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.enc_seq_len:
        batch["embeds"] = rng.randn(BATCH, cfg.enc_seq_len,
                                    cfg.d_model).astype(np.float32)
    return batch


def _configs(arch, dtype):
    return (dataclasses.replace(jax_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


@functools.lru_cache(maxsize=None)
def reference_loss(arch, dtype, s):
    """The reference's weights (numpy), batch, loss, metrics and
    gradients of ``loss_fn`` for one case; made once per module."""
    jcfg, _ = _configs(arch, dtype)
    jmodel = jzoo.build(jcfg)
    params = jzoo.init_params(jmodel, jax.random.key(0))
    batch = _batch(jcfg, s)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jzoo.loss_fn(jmodel, p, b), has_aux=True))
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            {k: float(v) for k, v in metrics.items()}, _np_tree(grads))


def port_loss(arch, dtype, s, remat="full"):
    params, batch, *_ = reference_loss(arch, dtype, s)
    _, tcfg = _configs(arch, dtype)
    model = tzoo.build(tcfg, settings=RunSettings(remat=remat))
    tparams = params_from_jax(model, params, device="cpu", master=True)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    (loss, metrics), grads = value_and_grad(model, tparams, tbatch)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def grad_errors(got, want):
    """{leaf path: max abs error / max(its largest gradient, GRAD_FLOOR
    of the tree's)}."""
    top = max(np.abs(w).max() for w in want.values())
    got = _np_tree(got)
    assert got.keys() == want.keys()
    return {k: float(np.abs(got[k] - w).max()
                     / max(np.abs(w).max(), GRAD_FLOOR * top))
            for k, w in want.items()}


# ---------------------------------------------------------------------------
# Cross-entropy and loss_fn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mask", ["none", "mask", "zero-mask"])
def test_softmax_xent_matches_reference(mask):
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 7, 50) * 4).astype(np.float32)
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    m = {"none": None, "mask": (rng.rand(3, 7) > 0.4).astype(np.float32),
         "zero-mask": np.zeros((3, 7), np.float32)}[mask]
    want = float(jax_xent(jnp.asarray(logits), jnp.asarray(labels),
                          None if m is None else jnp.asarray(m)))
    got = float(softmax_xent(torch.as_tensor(logits),
                             torch.as_tensor(labels),
                             None if m is None else torch.as_tensor(m)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,s", LOSS_CASES,
                         ids=[f"{a}-S{s}" for a, s in LOSS_CASES])
def test_loss_and_grads_match_reference(arch, s, dtype):
    _, _, want_loss, want_metrics, want_grads = reference_loss(arch, dtype, s)
    loss, metrics, grads = port_loss(arch, dtype, s)
    assert loss == pytest.approx(want_loss, rel=LOSS_TOL[dtype])
    assert metrics.keys() == want_metrics.keys()
    for k, v in want_metrics.items():
        assert metrics[k] == pytest.approx(v, rel=LOSS_TOL[dtype],
                                           abs=LOSS_TOL[dtype]), k
    if arch.startswith("granite-moe"):
        assert {"aux", "zloss"} <= metrics.keys()
        assert metrics["loss"] > metrics["xent"]
    errs = grad_errors(grads, want_grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL[dtype], (worst, errs[worst])


@pytest.mark.parametrize("mode", ["full", "dots_saveable"])
@pytest.mark.parametrize("arch,s", LOSS_CASES[:3] + LOSS_CASES[4:],
                         ids=[a for a, _ in LOSS_CASES[:3] + LOSS_CASES[4:]])
def test_remat_matches_none_and_recomputes(arch, s, mode, monkeypatch):
    """Remat changes memory, never values; and it does recompute: the
    forward of every rematerialised layer runs twice in a step."""
    calls = {"n": 0}
    for module, name in ((tzoo, "_block_apply"),
                         (tzoo.ssm_mod, "mamba2_apply")):
        real = getattr(module, name)

        def counted(*a, _real=real, **kw):
            calls["n"] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(module, name, counted)
    runs = {}
    for remat in ("none", mode):
        calls["n"] = 0
        runs[remat] = port_loss(arch, "float32", s, remat=remat), calls["n"]
    (loss0, _, g0), n0 = runs["none"]
    (loss1, _, g1), n1 = runs[mode]
    assert loss1 == loss0
    for (k, a), (_, b) in zip(_paths(g0), _paths(g1)):
        assert torch.equal(a, b), k
    # the hybrid's shared block is not rematerialised, as in the reference
    cfg = get_smoke_config(arch)
    shared = cfg.num_layers // cfg.attn_period if cfg.attn_period else 0
    assert n1 - n0 == n0 - shared


# ---------------------------------------------------------------------------
# Master trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted({a for a, _ in LOSS_CASES}))
def test_master_tree_matches_reference_structure(arch):
    jcfg, tcfg = _configs(arch, "bfloat16")
    jmodel, model = jzoo.build(jcfg), tzoo.build(tcfg)
    specs = dict(_paths(jzoo.param_specs(jmodel)))
    params = tzoo.init_params(model, seed=0, device="cpu", master=True)
    got = dict(_paths(params))
    assert got.keys() == specs.keys()
    for k, spec in specs.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert got[k].dtype == torch.float32, k
    assert tzoo.is_master(model, params)
    assert tzoo.param_count(params) == jzoo.param_count(specs)
    serving = tzoo.init_params(model, seed=0, device="cpu")
    assert not tzoo.is_master(model, serving)
    with pytest.raises(TypeError, match="master"):
        Trainer(model, TrainConfig(), _data(tcfg), params=serving,
                device="cpu")


# ---------------------------------------------------------------------------
# Optimizer and compression
# ---------------------------------------------------------------------------
def _opt_tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"layers": {"w": rng.randn(2, 6, 5).astype(np.float32) * scale,
                       "ln": {"scale": rng.randn(2, 6).astype(np.float32)
                              * scale}},
            "final": {"scale": rng.randn(6).astype(np.float32) * scale}}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


def test_schedule_matches_reference():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(jopt.schedule(jopt.AdamWConfig(**cfg), step))
        got = float(topt.schedule(topt.AdamWConfig(**cfg), step))
        assert got == pytest.approx(want, rel=1e-6), step


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0],
                         ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(grad_scale):
    params, grads = _opt_tree(0), _opt_tree(1, grad_scale)
    mu, nu = _opt_tree(2, 0.01), _to(_opt_tree(3, 0.01), np.abs)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20)
    jstate = {"mu": _to(mu, jnp.asarray), "nu": _to(nu, jnp.asarray),
              "step": jnp.asarray(4, jnp.int32)}
    tstate = {"mu": _to(mu, torch.as_tensor), "nu": _to(nu, torch.as_tensor),
              "step": torch.tensor(4, dtype=torch.int32)}
    jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg),
                                   _to(grads, jnp.asarray), jstate,
                                   _to(params, jnp.asarray))
    given = _to(params, torch.as_tensor)
    old_leaves = tree_leaves(given) + tree_leaves(tstate)
    old_values = [a.clone() for a in old_leaves]
    tp, ts, tm = topt.adamw_update(topt.AdamWConfig(**cfg),
                                   _to(grads, torch.as_tensor), tstate,
                                   given)
    # the given trees hold the update; their old tensors were not written
    assert tp is given and ts is tstate
    for a, b in zip(old_leaves, old_values):
        assert torch.equal(a, b)
    for name, got, want in (("params", tp, jp), ("mu", ts["mu"], js["mu"]),
                            ("nu", ts["nu"], js["nu"])):
        for (k, a), (_, b) in zip(_paths(got), _paths(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{name} {k}")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 5
    for k in ("grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6), k
    init = topt.adamw_init(_to(params, torch.as_tensor))
    assert init["step"].dtype == torch.int32 and int(init["step"]) == 0
    assert all(not a.any() for a in tree_leaves(init["nu"]))


def test_quantize_matches_reference_half_to_even():
    # scale 1: ties at .5 round to even, as jnp.round does
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49, -127.0],
                    np.float32)
    rand = np.random.RandomState(0).randn(300).astype(np.float32) * 0.01
    for x in (ties, rand, np.zeros(5, np.float32)):
        jq, js = jgc.quantize(jnp.asarray(x))
        tq, ts = tgc.quantize(torch.as_tensor(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(
            tgc.dequantize(tq, ts).numpy(),
            np.asarray(jgc.dequantize(jq, js)))


def test_compress_grads_matches_reference_over_steps():
    grads = [_opt_tree(s, 1e-3) for s in range(5)]
    jef = jgc.ef_init(_to(grads[0], jnp.asarray))
    tef = tgc.ef_init(_to(grads[0], torch.as_tensor))
    for g in grads:
        jd, jef = jgc.compress_grads(_to(g, jnp.asarray), jef)
        td, tef = tgc.compress_grads(_to(g, torch.as_tensor), tef)
        for got, want in ((td, jd), (tef, jef)):
            for (k, a), (_, b) in zip(_paths(got), _paths(want)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), k)


GROUP_WORKER = r"""
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.training import grad_compress as gc
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
g = {"w": torch.as_tensor(np.load(path)[rank])}
deq, ef = gc.compress_grads(g, gc.ef_init(g), group=dist.group.WORLD)
np.save(f"{path}.{rank}.npy", np.stack([deq["w"].numpy(), ef["w"].numpy()]))
dist.destroy_process_group()
"""


def test_compress_grads_over_a_group_matches_reference_psum(tmp_path):
    """Two gloo processes against the reference's psum over a vmapped
    axis of two."""
    g = np.random.RandomState(5).randn(2, 40).astype(np.float32) * 1e-3
    path = str(tmp_path / "g.npy")
    np.save(path, g)
    deq, ef = jax.vmap(lambda x: jgc.compress_grads(
        {"w": x}, {"w": jnp.zeros_like(x)}, axis_name="dp"),
        axis_name="dp")(jnp.asarray(g))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", GROUP_WORKER, str(r),
                               str(port), path], env=env)
             for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    for r in range(2):
        got = np.load(f"{path}.{r}.npy")
        np.testing.assert_allclose(got[0], np.asarray(deq["w"][r]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[1], np.asarray(ef["w"][r]))


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
SMOKE = "llama2-7b"


def _data(cfg, batch=8, seq=32):
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=0)


@functools.lru_cache(maxsize=None)
def smoke_model():
    return tzoo.build(get_smoke_config(SMOKE))


def test_trainer_matches_reference_trainer():
    """Three steps from the reference's weights, on an fp32-compute copy
    of the smoke config, against the reference's ``Trainer``."""
    jcfg, tcfg = _configs(SMOKE, "float32")
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jt = jtrainer.Trainer(
        jzoo.build(jcfg),
        jtrainer.TrainConfig(opt=jopt.AdamWConfig(**opt), microbatches=2),
        _data(jcfg), init_key=jax.random.key(3))
    model = tzoo.build(tcfg)
    params = params_from_jax(model, jax.tree.map(np.asarray, jt.params),
                             device="cpu", master=True)
    tt = Trainer(model, TrainConfig(opt=topt.AdamWConfig(**opt),
                                    microbatches=2),
                 _data(tcfg), params=params, device="cpu")
    jt.run(3, log=None)
    tt.run(3, log=None)
    for a, b in zip(jt.history, tt.history):
        assert a.keys() == b.keys()
        for k in a:
            assert b[k] == pytest.approx(a[k], rel=2e-4), (k, a, b)
    got, want = _np_tree(tt.params), _np_tree(jax.tree.map(np.asarray,
                                                           jt.params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4,
                                   err_msg=k)


def test_loss_decreases():
    tc = TrainConfig(opt=topt.AdamWConfig(lr=1e-3, warmup_steps=5,
                                          total_steps=100))
    tr = Trainer(smoke_model(), tc, _data(smoke_model().cfg), device="cpu")
    tr.run(25, log=None)
    assert tr.history[-1]["loss"] < tr.history[0]["loss"] - 0.2


def test_microbatching_equivalence():
    """grad accumulation over 4 microbatches == single big batch."""
    dc = _data(smoke_model().cfg, batch=8)
    t1 = Trainer(smoke_model(), TrainConfig(microbatches=1), dc, seed=7,
                 device="cpu")
    t4 = Trainer(smoke_model(), TrainConfig(microbatches=4), dc, seed=7,
                 device="cpu")
    t1.run(3, log=None)
    t4.run(3, log=None)
    for a, b in zip(tree_leaves(t1.params), tree_leaves(t4.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_checkpoint_restart_exact(tmp_path):
    tc = TrainConfig(checkpoint_dir=str(tmp_path), checkpoint_every=10,
                     async_checkpoint=False)
    model = smoke_model()
    tr = Trainer(model, tc, _data(model.cfg), device="cpu")
    tr.run(10, log=None)
    ref_params = [a.clone() for a in tree_leaves(tr.params)]
    tr.run(5, log=None)          # drift past the step-10 checkpoint
    tr2 = Trainer(model, tc, _data(model.cfg), device="cpu")
    assert tr2.step == 10
    for a, b in zip(ref_params, tree_leaves(tr2.params)):
        assert torch.equal(a, b)
    # continuing from the restore matches continuing without a crash
    tr2.run(5, log=None)
    for a, b in zip(tree_leaves(tr.params), tree_leaves(tr2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_checkpoint_atomicity_tmp_ignored(tmp_path):
    tc = TrainConfig(checkpoint_dir=str(tmp_path), checkpoint_every=5,
                     async_checkpoint=False)
    model = smoke_model()
    Trainer(model, tc, _data(model.cfg), device="cpu").run(5, log=None)
    # a crash mid-write: the stray tmp dir must be ignored
    os.makedirs(tmp_path / "step_99.tmp")
    assert Trainer(model, tc, _data(model.cfg), device="cpu").step == 5


def test_async_checkpoint_snapshots_before_the_writer(tmp_path):
    """The host copy is taken before ``save`` returns: a step after an
    async save does not leak into it."""
    tc = TrainConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2,
                     async_checkpoint=True)
    model = smoke_model()
    tr = Trainer(model, tc, _data(model.cfg), device="cpu")
    tr.run(2, log=None)
    at2 = [a.clone() for a in tree_leaves(tr.params)]
    tr.save(blocking=False)
    tr.run(1, log=None)
    tr.ckpt.wait()
    step, tree, _ = tr.ckpt.restore_latest(tr._state_tree())
    assert step == 2
    for a, b in zip(at2, tree_leaves(tree["params"])):
        assert torch.equal(a, b)


def test_run_with_restarts(tmp_path):
    """The supervisor resumes from checkpoints through injected
    failures."""
    tc = TrainConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2,
                     async_checkpoint=False)
    crashes = {"left": 2}
    model = smoke_model()

    class CrashyTrainer(Trainer):
        def run(self, n, log=None):
            for _ in range(n):
                super().run(1, log=None)
                # two failures at different points in the run
                if self.step in (6, 9) and crashes["left"] > 0:
                    crashes["left"] -= 1
                    raise InjectedFailure("node lost")
            return self.history[-1] if self.history else {}

    tr = run_with_restarts(
        lambda: CrashyTrainer(model, tc, _data(model.cfg, batch=4, seq=16),
                              device="cpu"),
        num_steps=10, log=None)
    assert tr.step == 10
    assert crashes["left"] == 0


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------
def _state_arrays(trainer):
    tree = trainer._state_tree()
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in _paths(tree)}


@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_checkpoint_restores_across_packages(direction, tmp_path):
    jcfg, tcfg = jax_smoke(SMOKE), get_smoke_config(SMOKE)
    jtc = jtrainer.TrainConfig(checkpoint_dir=str(tmp_path),
                               checkpoint_every=2, async_checkpoint=False)
    ttc = TrainConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2,
                      async_checkpoint=False)
    make_j = lambda: jtrainer.Trainer(jzoo.build(jcfg), jtc,  # noqa: E731
                                      _data(jcfg), init_key=jax.random.key(1))
    make_t = lambda: Trainer(tzoo.build(tcfg), ttc,  # noqa: E731
                             _data(tcfg), seed=1, device="cpu")
    writer, reader = (make_j, make_t) if direction == "reference-to-port" \
        else (make_t, make_j)
    w = writer()
    w.run(2, log=None)
    r = reader()
    assert r.step == 2 and r.data.cursor == 2
    want = {k: np.asarray(v) for k, v in _paths(jax.tree.map(
        np.asarray, w._state_tree()))} if direction == "reference-to-port" \
        else _state_arrays(w)
    got = _state_arrays(r) if direction == "reference-to-port" \
        else {k: np.asarray(v) for k, v in _paths(jax.tree.map(
            np.asarray, r._state_tree()))}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_both_packages_write_one_manifest(tmp_path):
    """The same tree (fp32, bf16, int32 and a 0-d leaf) gives the same
    manifest entries (file, shape, dtype, sha) in both packages, and each
    loads the other's bf16 bits."""
    rng = np.random.RandomState(0)
    w = rng.randn(3, 4).astype(np.float32)
    tree_t = {"a": {"w": torch.as_tensor(w),
                    "h": torch.as_tensor(w).to(torch.bfloat16)},
              "step": torch.tensor(7, dtype=torch.int32)}
    tree_j = {"a": {"w": jnp.asarray(w), "h": jnp.asarray(w, jnp.bfloat16)},
              "step": jnp.asarray(7, jnp.int32)}
    tckpt.CheckpointManager(str(tmp_path / "t")).save(1, tree_t)
    jckpt.CheckpointManager(str(tmp_path / "j")).save(1, tree_j)
    manifests = [json.loads((tmp_path / d / "step_1" / "manifest.json")
                            .read_text()) for d in ("t", "j")]
    assert manifests[0] == manifests[1]
    got_t, _ = tckpt.CheckpointManager(str(tmp_path / "j")).load(1, tree_t)
    got_j, _ = jckpt.CheckpointManager(str(tmp_path / "t")).load(1, tree_j)
    assert torch.equal(got_t["a"]["h"], tree_t["a"]["h"])
    np.testing.assert_array_equal(
        np.asarray(got_j["a"]["h"]).view(np.uint16),
        tree_t["a"]["h"].view(torch.int16).numpy().view(np.uint16))


# ---------------------------------------------------------------------------
# Kernel routes under autograd
# ---------------------------------------------------------------------------
def _qkv(requires_grad):
    rng = np.random.RandomState(0)
    q, k, v = (torch.as_tensor(rng.randn(1, 8, 2, 16).astype(np.float32))
               for _ in range(3))
    return q.requires_grad_(requires_grad), k, v


def test_pallas_attention_refuses_grad_as_the_reference_fails():
    q, k, v = _qkv(True)
    with pytest.raises(RuntimeError, match="no backward"):
        attend(q, k, v, causal=True, impl="pallas")
    with torch.no_grad():
        out = attend(q, k, v, causal=True, impl="pallas")
    naive = attend(q, k, v, causal=True, impl="naive")
    assert naive.requires_grad
    torch.testing.assert_close(out, naive.detach(), rtol=1e-5, atol=1e-5)
    # the reference: jax.grad through its flash kernel fails
    jq, jk, jv = (jnp.asarray(t.detach().numpy()) for t in (q, k, v))
    with pytest.raises(Exception):
        jax.grad(lambda x: jax_attend(x, jk, jv, causal=True,
                                      impl="pallas").sum())(jq)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no-state", "state0"])
def test_ssd_autograd_function_takes_the_plain_gradients(with_state):
    """``_ScanFunction`` with the plain version as its forward (the card
    gives it the kernels) differentiates as the plain version does."""
    rng = np.random.RandomState(0)
    b, s, h, p, g, n, chunk = 1, 24, 4, 8, 2, 8, 8

    def leaf(*shape, scale=1.0):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32)
                               * scale).requires_grad_()
    xbar, Bm, Cm = leaf(b, s, h, p), leaf(b, s, g, n), leaf(b, s, g, n)
    dA = (-torch.as_tensor(rng.rand(b, s, h).astype(np.float32))) \
        .requires_grad_()
    state0 = leaf(b, h, n, p) if with_state else None
    inputs = [t for t in (xbar, dA, Bm, Cm, state0) if t is not None]
    wy, wf = torch.randn(b, s, h, p), torch.randn(b, h, n, p)

    def scalar(y, fs):
        return (y * wy).sum() + (fs * wf).sum()

    y1, f1 = ssd_ops._ScanFunction.apply(ssd_ops._plain, chunk, xbar, dA,
                                         Bm, Cm, state0)
    got = torch.autograd.grad(scalar(y1, f1), inputs)
    y2, f2 = ssd_ops._plain(xbar, dA, Bm, Cm, chunk, state0)
    want = torch.autograd.grad(scalar(y2, f2), inputs)
    assert torch.equal(y1, y2) and torch.equal(f1, f2)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def test_train_cli_runs_on_the_cpu(tmp_path):
    out = tmp_path / "history.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "3", "--seq-len", "16", "--batch",
         "2", "--history-out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "arch=llama2-7b-smoke" in proc.stdout
    history = json.loads(out.read_text())
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in history)


def test_train_100m_example_matches_the_reference():
    spec = importlib.util.spec_from_file_location(
        "reference_train_100m", ROOT / "examples" / "train_100m.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert dataclasses.asdict(train_100m.CFG_100M) == \
        dataclasses.asdict(ref.CFG_100M)
    tc = train_100m.train_config(300, "/ckpt")
    assert tc.opt == topt.AdamWConfig(lr=6e-4, warmup_steps=30,
                                      total_steps=300)
    assert (tc.microbatches, tc.checkpoint_every, tc.log_every) == (2, 50, 10)
    dc = train_100m.data_config(8, 256)
    assert (dc.vocab_size, dc.seq_len, dc.global_batch, dc.seed) == \
        (32000, 256, 8, 0)
