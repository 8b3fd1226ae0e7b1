"""The port's sharding plan (``distributed/api.py``, ``shard_plan.py``,
``launch/mesh.py`` and the model hooks) against the reference's.

* The specs, leaf by leaf, against ``repro.distributed.shard_plan`` for
  every assigned config at tp=16, under the default settings and the two
  sharding variants; the other spec trees and the rule sets likewise.
* The production meshes on a fake process group of 256 and 512 ranks
  (``torch.testing._internal.distributed.fake_pg``, one process, no
  collective runs): every config at full width, on the meta device,
  placed with ``distribute``.
* Eight gloo ranks on a (4 data x 2 model) mesh (``torch_sharding_ranks.py``
  in eight processes): the reference's small-mesh check, qwen3-14b smoke
  at tp=2 from the reference's weights: gradients, train steps (plain
  and int8 error feedback), a checkpoint restored onto (2, 4) and onto no
  mesh, prefill and decode through the flash boundary, and a mamba2-130m
  prefill through the SSD-scan boundary; and stablelm-3b smoke, whose
  vocabulary tp pads (384 -> 512), so that its logits mask runs on the
  unembedding's partial sum: prefill, decode steps and a train step
  against the port's unsharded run and the reference's.  The reference's
  own small-mesh
  test fails at seed (a ``DuplicateSpecError`` in its embedding), so the
  sharded step is held to the reference's *unsharded* loss and to the
  port's unsharded step.

Tolerances, sharded against the port's unsharded run: the configs
compute in bf16, and a contraction over a sharded dim sums its partial
products in bf16 across ranks where the unsharded matmul accumulates in
fp32, so bf16-level differences (about 2^-8 of a value) reach the
gradients and logits; the loss, a mean in fp32, agrees far closer.  An
fp32-compute copy of the config bounds the plan's own error.  A fault of
the plan (a wrong head group, a lost shard) moves values by their own
size.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ASSIGNED as R_ASSIGNED
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.distributed import api as r_api
from repro.distributed import shard_plan as r_sp
from repro.models import model_zoo as r_zoo
from repro.models.common import RunSettings as R_RunSettings
from repro.training.optimizer import adamw_init as r_adamw_init
from repro.training.trainer import TrainConfig as R_TrainConfig
from repro.training.trainer import make_train_step as r_make_train_step

from repro_torch.configs import ASSIGNED, get_config, get_smoke_config
from repro_torch.distributed import api
from repro_torch.distributed import shard_plan as sp
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.models.common import RunSettings, tree_leaves

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: the sharding variants the reference's presets use
VARIANTS = {"default": {}, "no_fsdp": {"fsdp_params": False},
            "embed_fsdp": {"embed_shard": "fsdp"}}
#: rule sets: (multi_pod, seq_parallel)
RULE_SETS = [(False, False), (True, False), (False, True), (True, True)]
MESH_SIZES = {"data": 16, "model": 16, "pod": 2}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _ref_flat(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in flat}


def _ref_specs(tree):
    return {k: tuple(v) for k, v in _ref_flat(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    ).items()}


def _port_specs(tree):
    return {k: tuple(v) for k, v in _paths(tree)}


def _models(name, tp=16, **settings):
    return (r_zoo.build(r_get_config(name), tp=tp,
                        settings=R_RunSettings(**settings)),
            zoo.build(get_config(name), tp=tp,
                      settings=RunSettings(**settings)))


def _divides(shape, spec, sizes=MESH_SIZES):
    for dim, ax in zip(shape, spec):
        axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
        if dim % int(np.prod([sizes[a] for a in axes])):
            return False
    return True


def test_assigned_configs_are_the_reference_s():
    assert list(ASSIGNED) == list(R_ASSIGNED)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", ASSIGNED)
def test_param_pspecs_match_reference(name, variant):
    """The port's ``param_pspecs`` equal the reference's on every path,
    and every sharded dim divides by its mesh size (the reference's
    check in tests/test_sharding_and_dryrun.py)."""
    rmodel, model = _models(name, **VARIANTS[variant])
    want = _ref_specs(r_sp.param_pspecs(rmodel))
    got = _port_specs(sp.param_pspecs(model))
    assert got == want
    shapes = dict(_paths(zoo.param_specs(model)))
    for path, spec in got.items():
        assert len(spec) <= shapes[path].dim(), (path, spec)
        assert _divides(shapes[path].shape, spec), (path, spec)


@pytest.mark.parametrize("name", ASSIGNED)
def test_param_specs_match_reference(name):
    """``param_specs`` has every path, shape and dtype of the reference's
    (the master tree's dtypes), and allocates nothing."""
    rmodel, model = _models(name)
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _ref_flat(r_zoo.param_specs(rmodel)).items()}
    master = dict(_paths(zoo.param_specs(model, master=True)))
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in master.items()}
    assert got == want
    serving = dict(_paths(zoo.param_specs(model)))
    assert all(t.is_meta for t in list(master.values())
               + list(serving.values()))
    assert {k: tuple(v.shape) for k, v in serving.items()} == \
        {k: s for k, (s, _) in want.items()}


@pytest.mark.parametrize("name", ASSIGNED)
def test_state_batch_and_cache_specs_match_reference(name):
    """``opt_pspecs``, ``ef_pspecs``, ``batch_pspecs`` and ``cache_pspecs``
    under every rule set, and ``cache_specs``' shapes and dtypes."""
    rmodel, model = _models(name)
    assert _port_specs(sp.opt_pspecs(model)) == \
        _ref_specs(r_sp.opt_pspecs(rmodel))
    for comp in (False, True):
        assert _port_specs(sp.ef_pspecs(model, comp)) == \
            _ref_specs(r_sp.ef_pspecs(rmodel, comp))
    batch = dict.fromkeys(("tokens", "labels", "loss_mask", "embeds"))
    for multi_pod, seq_parallel in RULE_SETS:
        kw = dict(multi_pod=multi_pod, seq_parallel=seq_parallel)
        rules, r_rules = sp.default_rules(**kw), r_sp.default_rules(**kw)
        assert _port_specs(sp.batch_pspecs(batch, rules)) == \
            _ref_specs(r_sp.batch_pspecs(batch, r_rules))
        assert _port_specs(sp.cache_pspecs(model, rules)) == \
            _ref_specs(r_sp.cache_pspecs(rmodel, r_rules))
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in r_zoo.cache_specs(rmodel, 32, 256).items()}
    specs = zoo.cache_specs(model, 32, 256)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in specs.items()} == want
    assert all(v.is_meta for v in specs.values())
    # init_cache is built from the same struct
    cache = zoo.init_cache(model, 1, 8, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in cache.items()} == \
        {k: (v.shape, v.dtype)
         for k, v in zoo.cache_specs(model, 1, 8).items()}


@pytest.mark.parametrize("multi_pod,seq_parallel", RULE_SETS)
def test_rules_match_reference(multi_pod, seq_parallel):
    kw = dict(multi_pod=multi_pod, seq_parallel=seq_parallel)
    rules, r_rules = sp.default_rules(**kw), r_sp.default_rules(**kw)
    assert rules.rules == r_rules.rules
    assert api.DEFAULT_LOGICAL == r_api.DEFAULT_LOGICAL
    for name in api.DEFAULT_LOGICAL + (None, "unknown"):
        assert rules.get(name) == r_rules.get(name)
    assert tuple(rules.spec(*api.DEFAULT_LOGICAL)) == \
        tuple(r_rules.spec(*api.DEFAULT_LOGICAL))
    assert api.make_rules(b="x", a=("y", "z")).rules == \
        r_api.make_rules(b="x", a=("y", "z")).rules


def test_rules_spec():
    """The reference's test_rules_spec, on the port."""
    r = sp.default_rules(multi_pod=True)
    assert r.spec("batch", "seq") == api.PartitionSpec(("pod", "data"), None)
    r2 = sp.default_rules(seq_parallel=True)
    assert r2.spec("batch", "kv_seq") == api.PartitionSpec(None, ("data",))


def test_shard_and_local_are_noops_without_rules():
    x = torch.ones((4, 4))
    assert api.current_rules() is None and api.current_mesh() is None
    assert api.shard(x, "batch", None) is x
    assert api.local(lambda t: t, (("batch",),), (("batch",),))(x) is x
    assert api.axis_size("batch") == 1


@pytest.mark.parametrize("fake_world", [1], indirect=True)
def test_nested_rules_keep_implicit_replication(fake_world):
    """A ``use_rules`` inside another (a layer's recompute) leaves the
    outer one's implicit replication on when it exits; the outer one
    turns it off again on its own exit."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = port_mesh.make_host_mesh(data=1, model=1, device="cpu")
    rules = sp.default_rules()
    x = distribute_tensor(torch.ones(2), mesh, [Replicate(), Replicate()])
    with api.use_rules(mesh, rules):
        with api.use_rules(mesh, rules):
            assert (x + torch.ones(2)).full_tensor().tolist() == [2.0, 2.0]
        assert (x + torch.ones(2)).full_tensor().tolist() == [2.0, 2.0]
        assert api.current_rules() is rules
    assert api.current_rules() is None
    with pytest.raises(RuntimeError, match="mixed torch.Tensor"):
        x + torch.ones(2)


def test_run_settings_have_the_reference_s_fields():
    want = {f.name: f.default for f in dataclasses.fields(R_RunSettings)}
    got = {f.name: f.default for f in dataclasses.fields(RunSettings)}
    assert got == want
    with pytest.raises(ValueError, match="embed shard"):
        RunSettings(embed_shard="rows")


# ---------------------------------------------------------------------------
# The production meshes on a fake process group
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_world(request):
    """A fake process group of ``request.param`` ranks in this process,
    destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=request.param)
    try:
        yield request.param
    finally:
        dist.destroy_process_group()


def _local_shape(shape, spec, sizes):
    out = list(shape)
    for dim, ax in enumerate(spec):
        axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
        out[dim] //= int(np.prod([sizes[a] for a in axes]))
    return tuple(out)


@pytest.mark.parametrize("fake_world", [256, 512], indirect=True)
def test_production_mesh_shapes(fake_world):
    multi_pod = fake_world == 512
    mesh = port_mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    # the reference's shapes and names (repro/launch/mesh.py)
    assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
    assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                   else ("data", "model"))
    # a tuple entry shards one tensor dim over several mesh dims, in mesh
    # order; a repeated or unknown axis, or another order, is refused
    from torch.distributed.tensor import Replicate, Shard
    if multi_pod:
        assert api.placements(mesh, api.P(("pod", "data"), "model")) == \
            (Shard(0), Shard(0), Shard(1))
        with pytest.raises(ValueError, match="order"):
            api.placements(mesh, api.P(("data", "pod")))
    assert api.placements(mesh, api.P(None, "data")) == \
        ((Replicate(),) if multi_pod else ()) + (Shard(1), Replicate())
    with pytest.raises(ValueError, match="twice"):
        api.placements(mesh, api.P("data", "data"))
    with pytest.raises(ValueError, match="not one of"):
        api.placements(mesh, api.P("expert"))


@pytest.mark.parametrize("name", ASSIGNED)
@pytest.mark.parametrize("fake_world", [256, 512], indirect=True)
def test_production_mesh_places_every_config(fake_world, name):
    """Every leaf of the full-width master tree, and a decode cache,
    placed on the production mesh on the meta device: each rank's shard
    is the global shape divided by its spec."""
    multi_pod = fake_world == 512
    mesh = port_mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    model = zoo.build(get_config(name), tp=16)
    rules = sp.default_rules(multi_pod=multi_pod)
    for tree, specs in (
            (zoo.param_specs(model, master=True), sp.param_pspecs(model)),
            (zoo.cache_specs(model, 64, 256), sp.cache_pspecs(model, rules))):
        placed = dict(_paths(sp.distribute(tree, mesh, specs)))
        specs = dict(_paths(specs))
        for path, t in _paths(tree):
            x, spec = placed[path], specs[path]
            assert x.shape == t.shape and x.dtype == t.dtype, path
            assert tuple(x.to_local().shape) == _local_shape(
                t.shape, spec, sizes), (path, spec)
            assert x.to_local().is_meta, path


# ---------------------------------------------------------------------------
# Eight gloo ranks on a (4 data x 2 model) mesh
# ---------------------------------------------------------------------------
ARCH, TP = "qwen3-14b", 2
B, S = 8, 32
#: the decode steps each rank runs (torch_sharding_ranks.DECODE_STEPS)
DECODE_STEPS = 4
#: sharded against the port's unsharded run (see the module docstring):
#: the fp32 loss; gradients of the bf16 config, each leaf's largest
#: error over its largest gradient; of the fp32-compute config
LOSS_RTOL = 1e-4
GRAD_REL_BF16 = 5e-2
GRAD_REL_FP32 = 1e-4
#: logits (prefill and every decode step) and K/V caches, largest error
#: over the largest |logit| / the cache's own values, in bf16 and in fp32
#: compute
LOGIT_REL = 3e-2
LOGIT_REL_FP32 = 1e-4
#: the reference's own tolerance for its sharded loss
REF_LOSS_RTOL = 5e-3
#: updated parameters: the largest share, over leaves, of elements that
#: the sharded and the unsharded first AdamW step moved more than lr / 2
#: apart.  Each step moves an element by about lr; a gradient near 0
#: whose sign the two runs' bf16 sums flip moves it 2 lr apart, and with
#: int8 error feedback a gradient near half an int8 step also rounds to
#: 0 (no move) in one run and to one step (lr) in the other
UPDATE_OFF_SHARE = {"plain": 2e-2, "compressed": 5e-2}


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


#: a smoke config whose vocabulary tp pads (384 -> 512)
PADDED_ARCH = "stablelm-3b"


def _padded_reference(work, rng):
    """PADDED_ARCH's reference weights and batch for the ranks (with
    DECODE_STEPS decode tokens), and the reference's unsharded loss, and
    prefill and decode logits on them."""
    cfg = r_get_smoke_config(PADDED_ARCH)
    model = r_zoo.build(cfg, tp=TP)
    params = r_zoo.init_params(model, jax.random.key(1))
    np.savez(work / "params_padded.npz", **{
        k: np.asarray(v) for k, v in _ref_flat(params).items()})
    batch = {k: rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    decode = rng.randint(0, cfg.vocab_size,
                         (DECODE_STEPS, B)).astype(np.int32)
    np.savez(work / "batch_padded.npz", decode=decode, **batch)
    step = jax.jit(r_make_train_step(model, R_TrainConfig()))
    loss = step(params, r_adamw_init(params), {"_": jnp.zeros(())},
                {k: jnp.asarray(v) for k, v in batch.items()})[3]["loss"]
    cache = r_zoo.init_cache(model, B, S + DECODE_STEPS)
    logits, cache = r_zoo.prefill(model, params,
                                  {"tokens": jnp.asarray(batch["tokens"])},
                                  cache)
    out = [np.asarray(logits, np.float32)]
    for tok in decode:
        logits, cache = r_zoo.decode_step(model, params, cache,
                                          jnp.asarray(tok))
        out.append(np.asarray(logits, np.float32))
    return {"loss": float(loss), "logits": out,
            "vocab": cfg.vocab_size, "padded_vocab": model.plan.vocab}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's weights and unsharded losses, then the eight ranks;
    returns (rank 0's result, the reference's numbers)."""
    work = tmp_path_factory.mktemp("ranks")
    cfg = r_get_smoke_config(ARCH)
    rng = np.random.RandomState(0)
    batch = {k: rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    np.savez(work / "batch.npz", **batch)
    ref = {"padded": _padded_reference(work, rng)}
    for tag, c in (("bf16", cfg), ("fp32", dataclasses.replace(
            cfg, dtype="float32"))):
        model = r_zoo.build(c, tp=TP)
        params = r_zoo.init_params(model, jax.random.key(0))
        if tag == "bf16":
            np.savez(work / "params.npz", **{
                k: np.asarray(v) for k, v in _ref_flat(params).items()})
        step = jax.jit(r_make_train_step(model, R_TrainConfig()))
        out = step(params, r_adamw_init(params), {"_": jnp.zeros(())},
                   {k: jnp.asarray(v) for k, v in batch.items()})
        ref[tag] = float(out[3]["loss"])
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    logs = [open(work / f"rank{r}.log", "w") for r in range(8)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_sharding_ranks.py"),
         str(r), str(port), str(work)], env=env, stdout=log,
        stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p, log in zip(procs, logs):
            p.kill()
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, (
        failed, (work / f"rank{failed[0]}.log").read_text()[-4000:])
    with open(work / "result.json") as f:
        got = json.load(f)
    with np.load(work / "padded_logits.npz") as f:
        got["padded"]["logits"] = [f[f"arr_{i}"] for i in range(len(f))]
    return got, ref


def test_sharded_loss_matches_reference_unsharded(ranks):
    """The port's (4, 2)-sharded train step against the reference's
    unsharded ``make_train_step`` from the same weights and batch."""
    got, ref = ranks
    np.testing.assert_allclose(got["train"]["plain"]["loss"], ref["bf16"],
                               rtol=REF_LOSS_RTOL)
    np.testing.assert_allclose(got["grads_fp32"]["loss"], ref["fp32"],
                               rtol=REF_LOSS_RTOL)


@pytest.mark.parametrize("compute", ["bf16", "fp32"])
def test_sharded_gradients_match_unsharded(ranks, compute):
    got = ranks[0]["grads" if compute == "bf16" else "grads_fp32"]
    np.testing.assert_allclose(got["loss"], got["loss_unsharded"],
                               rtol=LOSS_RTOL)
    limit = GRAD_REL_BF16 if compute == "bf16" else GRAD_REL_FP32
    assert got["grads_rel_diff"] <= limit, got


@pytest.mark.parametrize("kind", ["plain", "compressed"])
def test_sharded_train_step_matches_unsharded(ranks, kind):
    """Loss, grad norm, updated parameters and AdamW state (and the
    error-feedback residual) against the port's unsharded step; the
    update keeps every leaf's placements.  Parameters: the first AdamW
    step moves each element by about lr (3e-6 at step 0) whatever the
    gradient's size, so the two steps' parameters are compared on the
    scale of lr, by the share of elements they moved apart.  The same
    check on planted faults (no parameter written back; any one leaf
    not written back) reads far past the limit."""
    got = ranks[0]["train"][kind]
    np.testing.assert_allclose(got["loss"], got["loss_unsharded"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], got["grad_norm_unsharded"],
                               rtol=GRAD_REL_BF16)
    limit = UPDATE_OFF_SHARE[kind]
    assert got["update_off_share"] <= limit, got
    assert got["planted_unchanged_off_share"] > limit, got
    assert got["planted_one_leaf_unchanged_off_share"] > limit, got
    assert got["mu_rel_diff"] <= GRAD_REL_BF16, got
    assert got["placements_kept"], got
    if kind == "plain":
        assert got["ef_max_diff"] == 0.0
    else:
        # the residual is each gradient's int8 rounding error, within half
        # a step either side, so two runs whose gradients differ in bf16
        # differ in it by at most about one step (their scales differ as
        # their largest gradients do)
        assert got["ef_diff_in_steps"] <= 1.05, got


def _serve_matches(got, limit):
    assert len(got["logits_max_diff"]) == 5
    assert max(got["logits_max_diff"]) <= limit * got["logits_max_abs"]
    assert got["cache_rel_diff"] <= limit, got


def test_sharded_prefill_and_decode_match_unsharded(ranks):
    _serve_matches(ranks[0]["serve"], LOGIT_REL)


def test_seq_parallel_prefill_and_decode_match_unsharded(ranks):
    """In fp32 compute, under the reference's long-context rules,
    ``default_rules(seq_parallel=True)``: the caches' sequence over
    "data", each rank writing the prompt's and the decode tokens' K/V
    only into its own positions (every decode token lands in the last
    rank's)."""
    _serve_matches(ranks[0]["serve_seq_parallel"], LOGIT_REL_FP32)


def test_misplaced_cache_write_is_refused(ranks):
    assert ranks[0]["misplaced_cache_refused"] is True


def test_flash_runs_on_local_shards(ranks):
    """With ``attn_impl="pallas"`` the prefill reaches the flash wrapper
    (its plain version here) once a layer, through the boundary: each
    rank holds a quarter of the batch and half of the heads."""
    cfg = r_get_smoke_config(ARCH)
    shapes = ranks[0]["serve"]["flash_local_shapes"]
    q = [B // 4, S, cfg.n_heads // TP, cfg.head_dim]
    kv = [B // 4, S, cfg.n_kv_heads // TP, cfg.head_dim]
    assert shapes == [[q, kv, kv]] * cfg.num_layers


def test_trainer_places_its_state_by_shardings(ranks):
    """Every leaf of the trainer's state where its ``shardings`` leaf
    says, the AdamW moments too when they are placed otherwise than the
    parameters."""
    assert ranks[0]["trainer_placements"] == {"plan": True,
                                               "moments_replicated": True}


def test_elastic_restore(ranks):
    """A save under (4, 2) restores onto (2, 4), placed by the plan, and
    onto no mesh, with equal values."""
    got = ranks[0]["checkpoint"]
    assert got == {"onto_2x4_max_diff": 0.0, "onto_2x4_placed": True,
                   "no_mesh_max_diff": 0.0, "no_mesh_plain": True}


def test_mamba_prefill_through_ssd_boundary(ranks):
    """mamba2-130m smoke, a prefill of two chunks under the plan: the SSD
    scan runs once a layer on each rank's quarter of the batch and half
    of the SSD heads (one B/C group, whole on every rank), and the
    logits and states equal the unsharded prefill's within the bf16
    limit."""
    got = ranks[0]["mamba"]
    want = got["ssd_unsharded_shapes"]
    assert len(got["ssd_local_shapes"]) == len(want) == 2
    for local, whole in zip(got["ssd_local_shapes"], want):
        x, da, bm, cm = whole
        assert local == [[x[0] // 4, x[1], x[2] // TP, x[3]],
                         [da[0] // 4, da[1], da[2] // TP],
                         [bm[0] // 4] + bm[1:], [cm[0] // 4] + cm[1:]]
    assert got["logits_max_diff"] <= LOGIT_REL * got["logits_max_abs"]
    assert got["cache_rel_diff"] <= LOGIT_REL, got


# ---------------------------------------------------------------------------
# A vocabulary that tp pads, under the plan
# ---------------------------------------------------------------------------
def test_padded_vocab_sizes():
    """The case's vocabulary is padded at tp (so the logits mask runs on
    the unembedding's partial sum), as the reference pads it."""
    ref = r_zoo.build(r_get_smoke_config(PADDED_ARCH), tp=TP).plan
    model = zoo.build(get_smoke_config(PADDED_ARCH), tp=TP)
    assert (model.plan.vocab_logical, model.plan.vocab) == \
        (ref.vocab_logical, ref.vocab) == (384, 512)


def test_padded_vocab_serve_matches_unsharded_and_reference(ranks):
    """Prefill and DECODE_STEPS decode steps under the plan, the padded
    columns masked on the unembedding's partial sum: every padded column
    holds the reference's -1e30, and the logits over the vocabulary
    equal the port's unsharded run's and the reference's unsharded ones
    within the bf16 limit."""
    got, ref = ranks
    padded, want = got["padded"], ref["padded"]
    assert (padded["vocab"], padded["padded_vocab"]) == \
        (want["vocab"], want["padded_vocab"])
    served = padded["serve"]
    assert served["pad_exact"] is True
    _serve_matches(served, LOGIT_REL)
    vocab = want["vocab"]
    assert len(padded["logits"]) == len(want["logits"]) == DECODE_STEPS + 1
    scale = max(np.abs(w[..., :vocab]).max() for w in want["logits"])
    for g, w in zip(padded["logits"], want["logits"]):
        assert g.shape == w.shape
        assert np.all(w[..., vocab:] == -1e30)
        assert np.abs(g[..., :vocab] - w[..., :vocab]).max() \
            <= LOGIT_REL * scale


def test_padded_vocab_train_step_matches(ranks):
    """The loss, gradients and a train step of the padded-vocabulary
    config under the plan, against the port's unsharded ones and the
    reference's unsharded loss."""
    got, ref = ranks
    padded = got["padded"]
    np.testing.assert_allclose(padded["grads"]["loss"],
                               padded["grads"]["loss_unsharded"],
                               rtol=LOSS_RTOL)
    assert padded["grads"]["grads_rel_diff"] <= GRAD_REL_BF16, padded
    train = padded["train"]["plain"]
    np.testing.assert_allclose(train["loss"], ref["padded"]["loss"],
                               rtol=REF_LOSS_RTOL)
    np.testing.assert_allclose(train["loss"], train["loss_unsharded"],
                               rtol=LOSS_RTOL)
    assert train["update_off_share"] <= UPDATE_OFF_SHARE["plain"], train
    assert train["placements_kept"], train
