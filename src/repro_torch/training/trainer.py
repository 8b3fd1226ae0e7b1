"""Training loop, microbatched, checkpointed and restartable: the port of
``repro.training.trainer``.

``train_step`` is the reference's: loss (+ MoE aux) -> gradients ->
optional int8 error-feedback compression -> AdamW.  With microbatches
(gradient accumulation) each microbatch's gradients are added up in fp32
and divided by their number, and the loss is the mean of the
microbatches' losses, as the reference's ``lax.scan`` does
(trainer.py:45-75).  The step runs eagerly; ``RunSettings.remat`` keeps
the activation memory of each layer down.

``Trainer`` trains a master tree (every leaf in ``cfg.param_dtype``, as
the reference's ``init_params`` builds it) and refuses any other: a
serving tree holds its matrices in the compute dtype.  The reference
seeds its weights from ``jax.random.key(seed)``; the port draws its own
from ``seed`` (``init_params(..., master=True)``), or takes an initial
``params`` tree (the reference's weights through
``convert.params_from_jax(..., master=True)``).  It runs on the CUDA card
unless given ``device="cpu"``.

``shardings`` (``shard_plan.named(mesh, {"params": ..., "opt": ...,
"ef": ...})``, a tree of ``(mesh, placements)`` over the state tree)
places the state on a mesh: the parameters, then ``mu``/``nu`` and the
error-feedback residual beside them and the step as its spec says; a
restore places what it loads by the same tree (the reference's
``shardings``, which it reads for the restore alone).  Its steps then run
under ``distributed.api.use_rules``, which the caller installs; with
rules installed each batch is placed by ``shard_plan.batch_pspecs``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed import api, shard_plan
from repro_torch.models import model_zoo as zoo
from repro_torch.models.common import resolve_device, tree_leaves, tree_map
from repro_torch.training import grad_compress
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import DataConfig, DataPipeline
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)


@dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    grad_compression: bool = False
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    async_checkpoint: bool = True
    log_every: int = 10


def _unflatten(template, flat):
    """A tree of ``template``'s structure from its leaves in sorted key
    order (``tree_leaves``'s)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(template)


def value_and_grad(model: zoo.Model, params, batch):
    """((loss, metrics), gradients) of ``zoo.loss_fn`` with respect to
    every leaf of ``params``, as ``jax.value_and_grad(..., has_aux=True)``
    returns them: the gradients in each leaf's dtype, zeros for a leaf
    the loss does not reach."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = zoo.loss_fn(model, live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), _unflatten(params, grads)


def make_train_step(model: zoo.Model, tc: TrainConfig):
    """Returns ``train_step(params, opt_state, ef_state, batch) ->
    (params, opt_state, ef_state, metrics)``.

    batch: {"tokens": (B,S), "labels": (B,S)} (and "embeds" for an
    encoder-decoder model) with B divisible by ``tc.microbatches``.
    """

    def train_step(params, opt_state, ef_state, batch):
        nmb = tc.microbatches
        if nmb > 1:
            mbatches = {k: v.reshape((nmb, v.shape[0] // nmb) + v.shape[1:])
                        for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            losses = []
            for i in range(nmb):
                (loss, _), g = value_and_grad(
                    model, params, {k: v[i] for k, v in mbatches.items()})
                tree_map(lambda acc, x: acc.add_(x.float()), gsum, g)
                losses.append(loss)
            grads = tree_map(lambda x: x / nmb, gsum)
            loss = torch.stack(losses).mean()
        else:
            (loss, _), grads = value_and_grad(model, params, batch)

        if tc.grad_compression:
            grads, ef_state = grad_compress.compress_grads(grads, ef_state)
        params, opt_state, om = adamw_update(tc.opt, grads, opt_state,
                                             params)
        metrics = {"loss": loss, **om}
        return params, opt_state, ef_state, metrics

    return train_step


def _place(tree, shardings):
    """Each leaf of ``tree`` on the ``(mesh, placements)`` of its leaf in
    ``shardings`` (a DTensor redistributed, a no-op where it lies so)."""
    def place(x, placed):
        if isinstance(x, DTensor):
            return x.redistribute(*placed)
        return distribute_tensor(x, *placed)
    return tree_map(place, tree, shardings)


class Trainer:
    def __init__(self, model: zoo.Model, tc: TrainConfig, dc: DataConfig,
                 *, seed: int = 0, params=None, device=None,
                 shardings=None):
        self.model = model
        self.tc = tc
        self.device = resolve_device(device)
        self.data = DataPipeline(dc)
        if params is None:
            params = zoo.init_params(model, seed, self.device, master=True)
        elif not zoo.is_master(model, params):
            raise TypeError(
                f"Trainer takes a master tree, every leaf in "
                f"{model.cfg.param_dtype} (init_params(..., master=True) or "
                f"params_from_jax(..., master=True)); this one is not")
        self.shardings = shardings
        self.params = tree_map(lambda p: p.to(self.device), params)
        if shardings is not None:
            # first, so that the optimizer's zeros are made shard by shard
            self.params = _place(self.params, shardings["params"])
        self.opt_state = adamw_init(self.params)
        self.ef_state = grad_compress.ef_init(self.params) \
            if tc.grad_compression \
            else {"_": torch.zeros((), device=self.device)}
        if shardings is not None:
            # every leaf as ``shardings`` places it, as a restore does
            state = _place(self._state_tree(), shardings)
            self.params, self.opt_state, self.ef_state = (
                state["params"], state["opt"], state["ef"])
        self.step = 0
        self.ckpt = CheckpointManager(tc.checkpoint_dir) \
            if tc.checkpoint_dir else None
        self._fn = make_train_step(model, tc)
        self.history: list = []
        if self.ckpt is not None:
            self._maybe_restore()

    # -- fault tolerance -------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state,
                "ef": self.ef_state}

    def _maybe_restore(self) -> bool:
        step, tree, extra = self.ckpt.restore_latest(
            self._state_tree(), shardings=self.shardings)
        if step is None:
            return False
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.ef_state = tree["ef"]
        self.step = step
        if "data" in extra:
            self.data.restore(extra["data"])
        return True

    def save(self, blocking: bool = True) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(self.step, self._state_tree(),
                       blocking=blocking or not self.tc.async_checkpoint,
                       extra={"data": self.data.state()})

    # -- loop --------------------------------------------------------------
    def run(self, num_steps: int, *, log=print) -> Dict[str, float]:
        last = {}
        for _ in range(num_steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.data.batch_at(self.data.cursor).items()}
            rules = api.current_rules()
            if self.shardings is not None and rules is not None:
                batch = shard_plan.distribute(
                    batch, api.current_mesh(),
                    shard_plan.batch_pspecs(batch, rules))
            self.data.cursor += 1
            self.params, self.opt_state, self.ef_state, m = self._fn(
                self.params, self.opt_state, self.ef_state, batch)
            self.step += 1
            last = {k: float(v) for k, v in m.items()}
            self.history.append({"step": self.step, **last})
            if log and self.step % self.tc.log_every == 0:
                log(f"step {self.step}: " +
                    " ".join(f"{k}={v:.4g}" for k, v in last.items()))
            if self.ckpt is not None and \
                    self.step % self.tc.checkpoint_every == 0:
                self.save(blocking=not self.tc.async_checkpoint)
        if self.ckpt is not None:
            self.ckpt.wait()
        return last
