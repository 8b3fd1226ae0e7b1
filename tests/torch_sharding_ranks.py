"""One rank of the port's 8-rank sharding check (tests/test_torch_sharding.py).

Run as ``python torch_sharding_ranks.py RANK PORT WORKDIR`` in eight
processes: a gloo group of 8 ranks on this host, the (4 data x 2 model)
mesh of the reference's small-mesh test.  WORKDIR holds ``params.npz``
(the reference's qwen3-14b smoke weights at tp=2, one array per
``/``-joined path) and ``batch.npz`` (tokens, labels), and the same of
the padded-vocabulary case (``params_padded.npz``; ``batch_padded.npz``
with its decode tokens); rank 0 writes ``result.json`` and that case's
sharded logits, ``padded_logits.npz``.  Every rank checks nothing
itself: the test reads the numbers.  It loads no jax.
"""
import dataclasses
import json
import os
import sys
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import shard_plan as sp
from repro_torch.distributed.api import P, make_rules, placements, use_rules
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.grad_compress import ef_init
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.data import DataConfig
from repro_torch.training.trainer import (TrainConfig, Trainer,
                                          make_train_step, value_and_grad)

ARCH, TP = "qwen3-14b", 2
#: a smoke config whose vocabulary tp pads (384 -> 512)
PADDED_ARCH = "stablelm-3b"
#: the reference's small-mesh rules (tests/test_sharding_and_dryrun.py)
RULES = make_rules(batch=("data",), heads="model", kv_heads="model",
                   ff="model", vocab="model", experts="model")
DECODE_STEPS = 4


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return tree


def full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def max_diff(a, b):
    """The largest |a - b| over the leaves of two trees (full values)."""
    return max(float((full(x).double() - full(y).double()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def clone(tree):
    return tree_map(lambda x: x.clone(), tree)


def same_placements(tree, mesh, specs):
    want = sp.named(mesh, specs)
    return all(isinstance(x, DTensor) and x.placements == w[1]
               for x, w in zip(tree_leaves(tree), tree_leaves(want)))


class Calls:
    """Records the local shapes each call of a wrapper receives."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.shapes = []

    def __enter__(self):
        def wrapper(*args, **kw):
            self.shapes.append([list(a.shape) for a in args
                                if isinstance(a, torch.Tensor)])
            return self.real(*args, **kw)
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def off_share(new, want, lr):
    """The largest share, over leaves, of elements of ``new`` that differ
    from ``want`` by more than lr / 2.  Two first AdamW steps from one
    tree differ only by their updates, and each moves an element by about
    lr whatever its gradient's size, so a share is where the two moved
    an element apart (a sign flip of a gradient near 0 among them)."""
    return max(leaf_off_shares(new, want, lr))


def leaf_off_shares(new, want, lr):
    return [float(((full(x).double() - full(y).double()).abs() > lr / 2)
                  .double().mean())
            for x, y in zip(tree_leaves(new), tree_leaves(want))]


def rel_diff(a, b):
    """The largest over leaves of max |a - b| / max |b| (full values);
    ``a`` and ``b`` are trees or lists of leaves."""
    def leaves(t):
        return t if isinstance(t, list) else tree_leaves(t)
    return max(float((full(x).double() - full(y).double()).abs().max()
                     / full(y).double().abs().max().clamp_min(1e-30))
               for x, y in zip(leaves(a), leaves(b)))


def gradients(model, params, batch, mesh):
    """``value_and_grad`` unsharded against the loss under the plan and
    its gradients taken on another thread, which sees no rules, as
    autograd's CUDA thread takes a backward on the card."""
    (loss, _), want = value_and_grad(model, params, batch)
    live = tree_map(lambda p: p.detach().requires_grad_(),
                    sp.distribute(params, mesh, sp.param_pspecs(model)))
    db = sp.distribute(batch, mesh, sp.batch_pspecs(batch, RULES))
    with use_rules(mesh, RULES):
        dloss, _ = zoo.loss_fn(model, live, db)
    got = []

    def backward():
        try:
            got.append(torch.autograd.grad(dloss, tree_leaves(live)))
        except Exception as e:  # noqa: BLE001 - re-raised on the caller
            got.append(e)

    thread = threading.Thread(target=backward)
    thread.start()
    thread.join()
    if isinstance(got[0], Exception):
        raise got[0]
    return {"loss": float(full(dloss).detach()), "loss_unsharded": float(loss),
            "grads_rel_diff": rel_diff(list(got[0]), tree_leaves(want))}


def train_steps(model, params, batch, mesh):
    """One train step unsharded and one under the plan, without and with
    int8 error feedback; the trees are copied first, since the update
    replaces their leaves."""
    out = {}
    # each leaf's int8 step at the first step (the residual starts at 0)
    steps = [float(g.abs().max()) / 127
             for g in tree_leaves(value_and_grad(model, params, batch)[1])]
    for comp in (False, True):
        step = make_train_step(model, TrainConfig(grad_compression=comp))
        p = clone(params)
        ef = ef_init(p) if comp else {"_": torch.zeros(())}
        want = step(p, adamw_init(p), ef, batch)
        dp = sp.distribute(clone(params), mesh, sp.param_pspecs(model))
        do = sp.distribute(adamw_init(clone(params)), mesh,
                           sp.opt_pspecs(model))
        de = sp.distribute(ef_init(clone(params)) if comp
                           else {"_": torch.zeros(())}, mesh,
                           sp.ef_pspecs(model, comp))
        db = sp.distribute(batch, mesh, sp.batch_pspecs(batch, RULES))
        with use_rules(mesh, RULES):
            got = step(dp, do, de, db)
        tag = "compressed" if comp else "plain"
        lr = float(want[3]["lr"])
        got_shares = leaf_off_shares(got[0], want[0], lr)
        kept_shares = leaf_off_shares(params, want[0], lr)
        out[tag] = {
            "loss": float(full(got[3]["loss"])),
            "loss_unsharded": float(want[3]["loss"]),
            "grad_norm": float(full(got[3]["grad_norm"])),
            "grad_norm_unsharded": float(want[3]["grad_norm"]),
            "lr": lr,
            "update_off_share": max(got_shares),
            # planted faults: no parameter written back, and the least
            # the check reads when any one leaf's write-back is lost
            "planted_unchanged_off_share": off_share(params, want[0], lr),
            "planted_one_leaf_unchanged_off_share": min(
                max(got_shares[:i] + [kept] + got_shares[i + 1:])
                for i, kept in enumerate(kept_shares)),
            "mu_rel_diff": rel_diff(got[1]["mu"], want[1]["mu"]),
            "ef_max_diff": max_diff(got[2], want[2]),
            "ef_diff_in_steps": max(
                float((full(x) - y).abs().max()) / step for x, y, step
                in zip(tree_leaves(got[2]), tree_leaves(want[2]), steps))
            if comp else None,
            "placements_kept": same_placements(
                got[0], mesh, sp.param_pspecs(model))
            and same_placements(got[1], mesh, sp.opt_pspecs(model)),
        }
        if not comp:
            state = {"params": got[0], "opt": got[1], "ef": got[2]}
    return out, state


def serve(model, params, prompt, mesh, rules=RULES, toks=None):
    """prefill plus DECODE_STEPS decode steps, unsharded and under
    ``rules``, on the same tokens (``toks``, or the unsharded run's
    greedy ones).  The logits are compared over the config's vocabulary;
    ``pad_exact`` says whether every padded column of the sharded run
    holds the reference's -1e30, and ``logits`` keeps the sharded run's
    logits for the caller."""
    b, s = prompt.shape
    vocab = model.cfg.vocab_size
    cache = zoo.init_cache(model, b, s + DECODE_STEPS, "cpu")
    logits, cache = zoo.prefill(model, params, {"tokens": prompt}, cache)
    want = [logits]
    greedy = toks is None
    toks = [] if greedy else toks
    tok = logits[:, -1].float().argmax(-1)
    for i in range(DECODE_STEPS):
        if greedy:
            toks.append(tok)
        logits, cache = zoo.decode_step(model, params, cache, toks[i])
        want.append(logits)
        tok = logits.float().argmax(-1)

    dparams = sp.distribute(params, mesh, sp.param_pspecs(model))
    dcache = sp.distribute(zoo.init_cache(model, b, s + DECODE_STEPS, "cpu"),
                           mesh, sp.cache_pspecs(model, rules))
    got = []
    with use_rules(mesh, rules), Calls(flash_ops, "flash_attention") as fl:
        batch = sp.distribute({"tokens": prompt}, mesh,
                              sp.batch_pspecs({"tokens": prompt}, rules))
        logits, dcache = zoo.prefill(model, dparams, batch, dcache)
        got.append(full(logits))
        for tok in toks:
            tok = distribute_tensor(tok, mesh,
                                    placements(mesh, rules.spec("batch")))
            logits, dcache = zoo.decode_step(model, dparams, dcache, tok)
            got.append(full(logits))
    return {
        "logits_max_diff": [float((g[..., :vocab].float()
                                   - w[..., :vocab].float()).abs().max())
                            for g, w in zip(got, want)],
        "logits_max_abs": max(float(w[..., :vocab].float().abs().max())
                              for w in want),
        "pad_exact": all(bool((g[..., vocab:] == -1e30).all()) for g in got),
        "cache_rel_diff": rel_diff(dcache, cache),
        "flash_local_shapes": fl.shapes,
        "logits": [g.float().numpy() for g in got]}


def padded_vocab(mesh, workdir):
    """PADDED_ARCH's smoke config, whose vocabulary tp pads (384 -> 512),
    from the reference's weights: its gradients and a train step, then a
    prefill and DECODE_STEPS decode steps on the test's tokens, each
    under the plan against the unsharded run.  The sharded logits go to
    ``padded_logits.npz`` for the test to hold to the reference's."""
    model = zoo.build(get_smoke_config(PADDED_ARCH), tp=TP)
    tree = unflatten(dict(np.load(os.path.join(workdir,
                                               "params_padded.npz"))))
    data = np.load(os.path.join(workdir, "batch_padded.npz"))
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    params = params_from_jax(model, tree, "cpu", master=True)
    out = {"vocab": model.cfg.vocab_size, "padded_vocab": model.plan.vocab,
           "grads": gradients(model, params, batch, mesh),
           "train": train_steps(model, params, batch, mesh)[0]}
    with torch.no_grad():
        served = serve(model, params_from_jax(model, tree, "cpu"),
                       batch["tokens"],
                       mesh, toks=[torch.from_numpy(t)
                                   for t in data["decode"]])
    logits = served.pop("logits")
    if dist.get_rank() == 0:
        np.savez(os.path.join(workdir, "padded_logits.npz"), *logits)
    out["serve"] = served
    return out


def trainer_placements(model, params, mesh):
    """``Trainer(shardings=)`` places its parameters, AdamW state and
    residual as the given specs say: the plan's, and the plan's with the
    AdamW moments replicated (placed otherwise than the parameters)."""
    specs = {"params": sp.param_pspecs(model), "opt": sp.opt_pspecs(model),
             "ef": sp.ef_pspecs(model, False)}
    whole = tree_map(lambda s: P(), specs["params"])
    out = {}
    for tag, tree in (("plan", specs), ("moments_replicated", dict(
            specs, opt=dict(specs["opt"], mu=whole, nu=whole)))):
        dc = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=8,
                        global_batch=8)
        trainer = Trainer(model, TrainConfig(), dc, params=clone(params),
                          device="cpu", shardings=sp.named(mesh, tree))
        out[tag] = same_placements(trainer._state_tree(), mesh, tree)
    return out


def misplaced_cache_refused(mesh):
    """A decode row write into a cache placed otherwise than its spec
    raises (its rows would land in a redistributed copy)."""
    cache = distribute_tensor(torch.zeros(8, 8, 2, 4), mesh,
                              [Replicate(), Replicate()])
    with use_rules(mesh, RULES):
        try:
            zoo._write_rows(cache, torch.zeros(8, dtype=torch.int32),
                            torch.ones(8, 2, 4))
        except ValueError:
            return True
    return False


def checkpoint(model, state, mesh, workdir):
    """Save the sharded state under (4, 2); load it onto (2, 4) and onto
    no mesh."""
    ckpt = CheckpointManager(os.path.join(workdir, "ckpt"))
    ckpt.save(1, state)
    specs = {"params": sp.param_pspecs(model), "opt": sp.opt_pspecs(model),
             "ef": sp.ef_pspecs(model, False)}
    mesh2 = make_host_mesh(data=2, model=4, device="cpu")
    onto, _ = ckpt.load(1, state, shardings=sp.named(mesh2, specs))
    plain, _ = ckpt.load(1, state)
    return {"onto_2x4_max_diff": max_diff(onto, state),
            "onto_2x4_placed": same_placements(onto, mesh2, specs),
            "no_mesh_max_diff": max_diff(plain, state),
            "no_mesh_plain": not any(isinstance(x, DTensor)
                                     for x in tree_leaves(plain))}


def mamba_prefill(mesh):
    """mamba2-130m smoke, one prefill of two chunks, unsharded and under
    the plan (the SSD scan at the boundary)."""
    cfg = get_smoke_config("mamba2-130m")
    model = zoo.build(cfg, tp=TP)
    params = zoo.init_params(model, 0, "cpu")
    b, s = 8, 2 * cfg.ssm.chunk_size
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (b, s)))
    with Calls(ssd_ops, "ssd_scan") as plain_calls:
        want, cache = zoo.prefill(model, params, {"tokens": tokens},
                                  zoo.init_cache(model, b, s, "cpu"))
    dparams = sp.distribute(params, mesh, sp.param_pspecs(model))
    dcache = sp.distribute(zoo.init_cache(model, b, s, "cpu"), mesh,
                           sp.cache_pspecs(model, RULES))
    with use_rules(mesh, RULES), Calls(ssd_ops, "ssd_scan") as calls:
        batch = sp.distribute({"tokens": tokens}, mesh,
                              sp.batch_pspecs({"tokens": tokens}, RULES))
        got, dcache = zoo.prefill(model, dparams, batch, dcache)
    return {"logits_max_diff": float((full(got).float()
                                      - want.float()).abs().max()),
            "logits_max_abs": float(want.float().abs().max()),
            "cache_rel_diff": rel_diff(dcache, cache),
            "ssd_local_shapes": calls.shapes,
            "ssd_unsharded_shapes": plain_calls.shapes}


def main():
    rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=8, rank=rank)
    try:
        mesh = make_host_mesh(data=4, model=2, device="cpu")
        cfg = get_smoke_config(ARCH)
        model = zoo.build(cfg, tp=TP)
        tree = unflatten(dict(np.load(os.path.join(workdir, "params.npz"))))
        data = np.load(os.path.join(workdir, "batch.npz"))
        batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
        params = params_from_jax(model, tree, "cpu", master=True)
        result = {}
        result["grads"] = gradients(model, params, batch, mesh)
        fp32 = zoo.build(dataclasses.replace(cfg, dtype="float32"), tp=TP)
        result["grads_fp32"] = gradients(
            fp32, params_from_jax(fp32, tree, "cpu", master=True), batch,
            mesh)
        result["train"], state = train_steps(model, params, batch, mesh)
        result["checkpoint"] = checkpoint(model, state, mesh, workdir)
        result["trainer_placements"] = trainer_placements(model, params,
                                                          mesh)
        served = model.with_settings(attn_impl="pallas")
        with torch.no_grad():
            result["serve"] = serve(served, params_from_jax(served, tree,
                                                            "cpu"),
                                    batch["tokens"], mesh)
            del result["serve"]["logits"]
            # the reference's long-context rules (the cache's sequence
            # over "data", the batch whole), in fp32 compute
            served = fp32.with_settings(attn_impl="pallas")
            result["serve_seq_parallel"] = serve(
                served, params_from_jax(served, tree, "cpu"),
                batch["tokens"], mesh, sp.default_rules(seq_parallel=True))
            del result["serve_seq_parallel"]["logits"]
            result["misplaced_cache_refused"] = misplaced_cache_refused(
                mesh)
            result["mamba"] = mamba_prefill(mesh)
        result["padded"] = padded_vocab(mesh, workdir)
        if rank == 0:
            with open(os.path.join(workdir, "result.json"), "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
