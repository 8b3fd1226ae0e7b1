"""Serving engine: continuous batching over a paged KV cache, or over
per-request slots of a contiguous cache.  The port of
``repro.serving.engine``.

The reference engine is the ground-truth system the simulator is
validated against: it plans each iteration with the simulator's own
``BlockManager`` and ``ContinuousBatching``, so its batch and memory
traces are exact, and its iteration walls calibrate the simulator's
``TabularBackend``.  The port keeps its own copies of those classes
(``repro_torch.core``); tests/test_torch_engine.py holds it to the
reference engine's greedy tokens and iteration records, one by one.

Attention families run the paged path.  SSM, hybrid and
encoder-decoder models run the slot path: one contiguous cache of ``max_batch`` rows
(``model_zoo.init_cache``), a row ("slot") held by each running request,
taken on admission and given back on preemption and on finish.  A
prefill runs ``model_zoo.prefill`` on the prompt padded to its
power-of-two bucket with no mask, as the reference does, so the states
written to the slot have absorbed the padding's zero tokens; only the
first token is read at the last real position.  An encoder-decoder
prefill also encodes the request's frame embeddings (``_enc_embeds``,
the reference's stand-in for an audio frontend, drawn from the request
id) and writes the cross-attention K/V whole into the slot.  A hybrid
prefill writes every layer's states and each shared-block application's
K/V; the slot write copies every batch-major cache array alike.  A
decode step runs every slot, empty ones included.  A family of neither
path raises ``NotImplementedError``.

``device=None`` means the CUDA card; without one the engine raises.
Each iteration wall ends with a device synchronisation.

On the card the engine runs its steps as CUDA graphs (``serving.graphs``),
as the reference runs them as ``jax.jit`` programs: the decode step, of
fixed shape (``max_batch`` rows, full-width tables), and the prefill
forward of each power-of-two bucket (an encoder-decoder model's encoder
included), each captured at its first use.
``graphs=False`` runs the same steps eagerly; the CPU always does, and
``graphs=True`` on the CPU raises.  What depends on a request's real
length stays eager, outside the graphs: picking the last real row of the
prefill's logits, ``scatter_prefill`` and the slot writes.  Sampling
stays outside too, as the reference keeps ``sample_token`` a program of
its own.

Either way the steps read static inputs: tensors made once, here, and
refilled in place every step (``copy_`` from pinned host buffers,
without a host sync), and persistent state (the page store, the slot
cache) is only ever written in place.  The slot engine keeps every
slot's length on the host too, so it reads nothing back from the card.
A pinned buffer is written again only after a host sync (each request's
sampling), so no copy from it is still pending.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HYBRID, SSM
from repro_torch.core.costmodel.operators import BatchMix
from repro_torch.core.mem.block_manager import BlockManager, MemoryConfig
from repro_torch.core.request import Request, State
from repro_torch.core.sched.local import make_local_scheduler
from repro_torch.models import model_zoo as zoo
from repro_torch.models.common import resolve_device
from repro_torch.serving import paged_model
from repro_torch.serving.graphs import StepGraphs
from repro_torch.serving.sampling import sample_token


#: families served on the slot path
SLOT_FAMILIES = (SSM, HYBRID) + zoo.ENCDEC_FAMILIES


@dataclass
class EngineConfig:
    num_blocks: int = 256
    block_size: int = 16
    max_batch: int = 8
    max_batched_tokens: int = 2048
    max_pages_per_seq: int = 32
    local_policy: str = "continuous"
    attn_path: str = "gather"            # gather | pallas
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    max_mem_ratio: float = 1.0


@dataclass
class IterationRecord:
    mix: BatchMix
    wall: float
    t_virtual: float
    batch_ids: Tuple[int, ...]
    kind: str                            # prefill | decode


class ServingEngine:
    """``pool`` (a multi-round KV pool with ``store``/``lookup``) and
    ``discipline`` (a tenant-aware queue order with ``select``,
    ``victim_key``, ``admit_key`` and ``on_service_start``) are taken by
    duck typing, as the reference's scheduler uses them.  ``graphs``:
    run the steps as CUDA graphs; ``None`` means yes on the card, no on
    the CPU."""

    def __init__(self, model: zoo.Model, params, ec: EngineConfig,
                 pool=None, discipline=None, device=None,
                 graphs: Optional[bool] = None):
        self.paged = paged_model.supports_paged(model)
        if not self.paged and model.cfg.family not in SLOT_FAMILIES:
            raise NotImplementedError(
                f"{model.cfg.name}: the slot-cache path for family "
                f"{model.cfg.family!r} is not ported yet")
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.ec = ec
        #: tenant-aware queue ordering; None = FIFO
        self.discipline = discipline

        mc = MemoryConfig(num_blocks=ec.num_blocks,
                          block_size=ec.block_size,
                          kv_bytes_per_token=1.0,
                          watermark=max(0.0, 1.0 - ec.max_mem_ratio))
        # scheduler shim state (same classes as the simulator's Worker)
        self.mem = BlockManager(mc)
        self.pool = pool
        self.waiting: deque = deque()
        self.running: List[Request] = []
        self.sched = make_local_scheduler(
            ec.local_policy, max_batch=ec.max_batch,
            max_batched_tokens=ec.max_batched_tokens)

        self.max_ctx = ec.max_pages_per_seq * ec.block_size
        if graphs is None:
            graphs = self.device.type == "cuda"
        #: the CUDA graphs of the steps; None runs them eagerly
        self.graphs = StepGraphs(self.device) if graphs else None

        if self.paged:
            # physical page `num_blocks` is the trash page for padded slots
            self.pages = paged_model.init_pages(
                model, ec.num_blocks + 1, ec.block_size, ec.max_batch,
                ec.max_pages_per_seq, self.device)
            self.trash_page = ec.num_blocks
        else:
            self.cache = zoo.init_cache(model, ec.max_batch, self.max_ctx,
                                        self.device)
            self.slot_of: Dict[int, int] = {}
            self.free_slots = list(range(ec.max_batch))[::-1]
            #: every slot's length, as ``cache["len"]`` holds it
            self.slot_len = np.zeros((ec.max_batch,), np.int32)

        # static inputs: the decode step's tokens, the prefill's tokens
        # (a bucket takes the first columns), (paged) the prefill's table
        # row and (encoder-decoder) the prefill's frame embeddings, each
        # with a host buffer it is filled from
        def static(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        bsz, mp = ec.max_batch, ec.max_pages_per_seq
        pin = self.device.type == "cuda"
        self._host = {
            "tokens": torch.zeros((bsz,), dtype=torch.int64, pin_memory=pin),
            "prompt": torch.zeros((self.max_ctx,), dtype=torch.int64,
                                  pin_memory=pin),
            "lens": torch.zeros((bsz,), dtype=torch.int32, pin_memory=pin),
            "tables": torch.zeros((bsz, mp), dtype=torch.int32,
                                  pin_memory=pin),
            "table_row": torch.zeros((mp,), dtype=torch.int64,
                                     pin_memory=pin)}
        self._tokens = static((bsz,), torch.int64)
        self._table_row = static((mp,), torch.int64)
        self._prompt = static((1, self.max_ctx), torch.int64)
        self._embeds = None
        if model.cfg.family in zoo.ENCDEC_FAMILIES:
            frames = (1, model.cfg.enc_seq_len, model.cfg.d_model)
            self._host["embeds"] = torch.zeros(frames, dtype=torch.float32,
                                               pin_memory=pin)
            self._embeds = static(frames, torch.float32)

        self.tokens_by_req: Dict[int, List[int]] = {}
        self.prompt_tokens: Dict[int, np.ndarray] = {}
        self.clock = 0.0                 # virtual time (sum of iter walls)
        self.records: List[IterationRecord] = []
        self.finished: List[Request] = []
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(ec.seed)

    # ------------------------------------------------------------------
    def add_request(self, req: Request, prompt_tokens=None) -> None:
        if prompt_tokens is None:
            rng = np.random.RandomState(req.id % (2 ** 31))
            prompt_tokens = rng.randint(
                0, self.model.plan.vocab_logical,
                size=(req.prompt_len,)).astype(np.int32)
        if req.prompt_len + req.output_len > self.max_ctx:
            raise ValueError(
                f"request {req.id}: prompt {req.prompt_len} + output "
                f"{req.output_len} exceeds the context {self.max_ctx}")
        self.prompt_tokens[req.id] = np.asarray(prompt_tokens, np.int32)
        self.tokens_by_req[req.id] = []
        req.state = State.WAITING
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- waiting-queue protocol shared with the simulator's Worker -------
    def next_waiting(self) -> Optional[Request]:
        if not self.waiting:
            return None
        if self.discipline is None:
            return self.waiting[0]
        return self.discipline.select(self.waiting, self.clock)

    def pop_waiting(self, req: Request) -> None:
        self.waiting.remove(req)

    def victim_sort_key(self):
        if self.discipline is None:
            return lambda r: (r.arrival_time, r.id)
        return self.discipline.victim_key(self.clock)

    # ------------------------------------------------------------------
    def step(self) -> Optional[IterationRecord]:
        plan = self.sched.plan(self)
        if plan.empty:
            return None
        for req in plan.admitted:
            req.state = State.PREFILL if req.remaining_prefill else \
                State.DECODE
            if req not in self.running:
                self.running.append(req)
            if self.discipline is not None:
                self.discipline.on_service_start(req, self.clock)
            if not self.paged:
                self.slot_of[req.id] = self.free_slots.pop()
        for req in plan.preempted:
            req.state = State.PREEMPTED
            if req in self.running:
                self.running.remove(req)
            if not self.paged and req.id in self.slot_of:
                self.free_slots.append(self.slot_of.pop(req.id))
            self.waiting.appendleft(req)

        for req in plan.decode:
            self.mem.append_tokens(req, 1)

        t0 = time.perf_counter()
        if plan.prefill:
            self._run_prefill(plan)
            kind = "prefill"
            batch = tuple(r.id for r, _, _ in plan.prefill)
        else:
            self._run_decode(plan)
            kind = "decode"
            batch = tuple(r.id for r in plan.decode)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0

        mix = BatchMix.from_batch(
            [(c, b) for _, c, b in plan.prefill],
            [r.context_len for r in plan.decode])
        self.clock += wall
        rec = IterationRecord(mix=mix, wall=wall, t_virtual=self.clock,
                              batch_ids=batch, kind=kind)
        self.records.append(rec)

        now = self.clock
        for req, chunk, _ in plan.prefill:
            req.prefill_done_len = max(req.cached_len,
                                       req.prefill_done_len) + chunk
            if req.remaining_prefill == 0:
                self._emit(req, now)
        for req in plan.decode:
            self._emit(req, now)
        return rec

    def run(self, max_steps: int = 1_000_000) -> None:
        steps = 0
        while self.has_work and steps < max_steps:
            if self.step() is None:
                break
            steps += 1

    # ------------------------------------------------------------------
    def _emit(self, req: Request, now: float) -> None:
        first = req.tokens_generated == 0
        req.tokens_generated += 1
        req.token_times.append(now)
        if first:
            req.t_first_token = now
        req.state = State.DECODE
        if req.finished:
            req.state = State.FINISHED
            req.t_finish = now
            self.running.remove(req)
            self.mem.free(req)
            if self.pool is not None:
                self.pool.store(req.session_id, req.context_len)
            if not self.paged:
                self.free_slots.append(self.slot_of.pop(req.id))
            self.finished.append(req)

    # -- prefill -----------------------------------------------------------
    def _full_sequence(self, req: Request) -> np.ndarray:
        return np.concatenate([
            self.prompt_tokens[req.id],
            np.asarray(self.tokens_by_req[req.id], np.int32)])

    @staticmethod
    def _bucket(n: int) -> int:
        """Pad prompt lengths to power-of-two buckets, as the reference
        does for its jit cache, so both engines run the same shapes."""
        return max(8, 1 << (int(n) - 1).bit_length())

    def _run_prefill(self, plan) -> None:
        for req, chunk, ctx in plan.prefill:
            seq = self._full_sequence(req)[:ctx + chunk]
            plen = int(seq.shape[0])
            spad = min(self._bucket(plen), self.max_ctx)
            prompt = self._host["prompt"][:spad]
            prompt.zero_()
            prompt.numpy()[:plen] = seq
            toks = self._prompt[:, :spad]
            self._upload(toks, prompt)
            if self.paged:
                logits, k, v = self._step(
                    ("prefill", spad), lambda: paged_model.prefill_forward(
                        self.model, self.params, toks))
                row = self._host["table_row"]
                row.fill_(self.trash_page)
                blocks = self.mem.block_table(req)
                row.numpy()[:len(blocks)] = blocks
                self._upload(self._table_row, row)
                paged_model.scatter_prefill(self.model, self.pages, k, v,
                                            self._table_row, plen)
            else:
                if self._embeds is not None:
                    self._host["embeds"].numpy()[0] = self._enc_embeds(req)
                    self._upload(self._embeds, self._host["embeds"])
                logits, cache1 = self._step(
                    ("prefill", spad), lambda: self._prefill_slot(toks))
                self._write_slot(self.slot_of[req.id], cache1)
            self.tokens_by_req[req.id].append(
                self._sample(logits[0, plen - 1]))
            self._slot_write_len(req, plen)

    def _prefill_slot(self, toks):
        """The slot path's prefill forward on the bucket's static tokens
        (and frame embeddings): logits (1,S,V) and the single-request
        cache but its ``len`` (``conv``/``ssd``; ``k``/``v``/``xk``/
        ``xv``)."""
        cache1 = zoo.init_cache(self.model, 1, self.max_ctx, self.device)
        batch = {"tokens": toks}
        if self._embeds is not None:
            batch["embeds"] = self._embeds
        logits, cache1 = zoo.prefill(self.model, self.params, batch, cache1)
        return logits, {k: v for k, v in cache1.items() if k != "len"}

    def _enc_embeds(self, req: Request) -> np.ndarray:
        """The request's frame embeddings (enc_seq_len, d_model), fp32:
        the reference's draw (engine.py:266-270), bit for bit."""
        rng = np.random.RandomState((req.id + 7919) % (2 ** 31))
        return rng.randn(self.model.cfg.enc_seq_len,
                         self.model.cfg.d_model).astype(np.float32)

    def _write_slot(self, slot: int, cache1) -> None:
        """Copy a single-request cache into row ``slot`` of every cache
        array whose dimension 1 is the batch; ``len`` is written apart."""
        for key, dst in self.cache.items():
            if key != "len" and dst.dim() >= 2 \
                    and dst.shape[1] == self.ec.max_batch:
                dst[:, slot] = cache1[key][:, 0]

    def _slot_write_len(self, req: Request, length: int) -> None:
        if not self.paged:
            self.slot_len[self.slot_of[req.id]] = length
            self._upload_slot_len()

    def _upload_slot_len(self) -> None:
        lens = self._host["lens"]
        lens.numpy()[:] = self.slot_len
        self._upload(self.cache["len"], lens)

    # -- steps -------------------------------------------------------------
    def _upload(self, dst, host) -> None:
        """Refill the static input ``dst`` from its host buffer."""
        dst.copy_(host, non_blocking=True)

    def _step(self, key, step):
        """Run ``step``: its CUDA graph ``key`` on the card, else eagerly."""
        if self.graphs is None:
            return step()
        return self.graphs.run(key, step)

    # -- decode ------------------------------------------------------------
    def _run_decode(self, plan) -> None:
        if not self.paged:
            self._run_decode_slots(plan.decode)
            return
        reqs = plan.decode
        tables, lens, toks = (self._host[k].numpy()
                              for k in ("tables", "lens", "tokens"))
        tables.fill(self.trash_page)
        lens.fill(0)
        toks.fill(0)
        for i, r in enumerate(reqs):
            bt = self.mem.block_table(r)
            tables[i, :len(bt)] = bt
            lens[i] = r.context_len - 1      # KV before this token
            toks[i] = self._current_token(r)
        self._upload(self.pages["tables"], self._host["tables"])
        self._upload(self.pages["len"], self._host["lens"])
        self._upload(self._tokens, self._host["tokens"])
        logits = self._step(
            ("decode",), lambda: paged_model.paged_decode_step(
                self.model, self.params, self.pages, self._tokens,
                self.ec.attn_path)[0])
        for i, r in enumerate(reqs):
            self.tokens_by_req[r.id].append(self._sample(logits[i]))

    def _run_decode_slots(self, reqs) -> None:
        """One decode step over every slot; empty slots decode token 0."""
        toks = self._host["tokens"].numpy()
        toks.fill(0)
        for r in reqs:
            slot = self.slot_of[r.id]
            toks[slot] = self._current_token(r)
            self.slot_len[slot] = r.context_len - 1
        self._upload_slot_len()
        self._upload(self._tokens, self._host["tokens"])
        logits = self._step(("decode",), lambda: zoo.decode_step(
            self.model, self.params, self.cache, self._tokens)[0])
        self.slot_len += 1                   # the step advanced every slot
        for r in reqs:
            self.tokens_by_req[r.id].append(
                self._sample(logits[self.slot_of[r.id]]))

    def _current_token(self, req: Request) -> int:
        gen = self.tokens_by_req[req.id]
        if gen:
            return int(gen[-1])
        return int(self.prompt_tokens[req.id][-1])

    def _sample(self, logits) -> int:
        return sample_token(logits, self._gen, greedy=self.ec.greedy,
                            temperature=self.ec.temperature,
                            vocab_logical=self.model.plan.vocab_logical)
