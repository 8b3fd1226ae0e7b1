"""repro_torch.models.model_zoo against repro.models.model_zoo.

One case per DENSE/MOE/VLM entry of ``repro.configs.SMOKE_CONFIGS``:
llama2, qwen3 (qk-norm, GQA), qwen2 (qkv bias, tied embeddings, GQA
7/1), internlm2 (GQA), opt (learned positions, LayerNorm, GELU, MLP
biases), stablelm (LayerNorm, SwiGLU), chameleon (VLM, qk-norm) and the
two granite MoE models (token-choice top-2 of 4 and of 5 experts, GQA
2/1 and 3/1, tied embeddings).
Each smoke model is made in fp32 by the reference and loaded with
``params_from_jax`` (``model_pair``, shared with
tests/test_torch_engine.py):

* the registry holds verbatim copies of the reference's configs;
* the parameter tree of ``init_params`` has the reference's keys and
  shapes (opt's MLP biases and position table among them);
* ``forward`` logits, ``prefill`` logits and KV, and three
  ``decode_step``s agree to 1e-4 (fp32 through two layers; the
  libraries sum in other orders), once with the naive attention and once
  with ``pallas``, which is the Pallas kernel in interpret mode on the
  reference side and the flash kernel's plain version on the port's;
  the MoE models' ``forward`` also returns the ``aux`` and ``zloss``
  values summed over layers, held to the same tolerance, and they run
  once more on the ``sort`` MoE route (``RunSettings.moe_impl``).
  The reference's entry points run under ``jax.jit``, as its engine
  runs them (one compile per model and shape instead of one per
  operation).

The encoder-decoder family runs the same comparisons on whisper-base's
smoke config, as AUDIO and as ENCDEC (``ENCDEC_ARCHS``): ``forward``
with frame embeddings, ``prefill`` logits and the self- and
cross-attention caches (``k``, ``v``, ``xk``, ``xv``), three
``decode_step``s, on both attention routes, and the parameter tree (no
``unembed``; the embedding table, the decoder's output table too, in
fp32).

llama2-7b's smoke model runs the same comparisons once more in fp16
(``model_pair(..., dtype="float16")``), on both attention routes, within
``FP16_TOL``.

A decode past the end of opt's learned position table reads the table's
last row, as the reference's gather does (JAX clamps the index; torch
indexing would raise): held on the contiguous decode step, at a
``max_seq_len`` shorter than the contexts.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SMOKE_CONFIGS as JAX_SMOKE  # noqa: E402
from repro.configs import CONFIGS as JAX_CONFIGS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro_torch.configs import (CONFIGS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.configs.base import ENCDEC, DENSE, MOE, VLM  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402

#: the reference's dense, MoE and VLM architectures (static data)
ARCHS = sorted(name for name, cfg in JAX_SMOKE.items()
               if cfg.family in (DENSE, MOE, VLM))
MOE_ARCHS = [name for name in ARCHS if JAX_SMOKE[name].family == MOE]
#: whisper-base as its own family (AUDIO), and the same config as ENCDEC
AS_ENCDEC = "-as-encdec"
ENCDEC_ARCHS = ["whisper-base", "whisper-base" + AS_ENCDEC]
FORWARD = jax.jit(jzoo.forward, static_argnums=0)
PREFILL = jax.jit(jzoo.prefill, static_argnums=0)
DECODE = jax.jit(jzoo.decode_step, static_argnums=0)
TOL = 1e-4
S = 24


def arch_cases(impls, archs=ARCHS):
    """(arch, impl) cases of every arch; llama2-7b's ids are the impl
    alone, as they were when it was the only arch."""
    return [pytest.param(arch, impl,
                         id=impl if arch == "llama2-7b" else f"{arch}-{impl}")
            for arch in archs for impl in impls]


def _overrides(arch):
    """(registry name, config overrides) of a case's arch."""
    if arch.endswith(AS_ENCDEC):
        return arch[:-len(AS_ENCDEC)], {"family": ENCDEC}
    return arch, {}


def case_pair(arch, seed=0, dtype="float32"):
    """``model_pair`` of an arch of ``ARCHS``, ``ENCDEC_ARCHS`` or the
    slot path's mamba2-130m."""
    name, overrides = _overrides(arch)
    return model_pair(name, seed, dtype, **overrides)


def case_config(arch):
    """The port's smoke config of a case's arch (bf16, as registered)."""
    name, overrides = _overrides(arch)
    return dataclasses.replace(get_smoke_config(name), **overrides)


def frame_embeds(cfg, batch, seed=0):
    """Encoder input of an encoder-decoder model, (B, Senc, d) fp32."""
    return np.random.RandomState(seed).randn(
        batch, cfg.enc_seq_len, cfg.d_model).astype(np.float32)


@functools.lru_cache(maxsize=None)
def model_pair(arch, seed=0, dtype="float32", **overrides):
    """The reference's smoke model in ``dtype`` (fp32 unless asked) and
    its weights, and the port's with the same weights loaded; made once
    per arguments (no test writes into the weights)."""
    jcfg = dataclasses.replace(JAX_SMOKE[arch], dtype=dtype, **overrides)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               **overrides)
    jmodel = jzoo.build(jcfg)
    params = jzoo.init_params(jmodel, jax.random.key(seed))
    tmodel = tzoo.build(tcfg)
    tparams = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              device="cpu")
    return jmodel, params, tmodel, tparams


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_every_dense_and_vlm_arch_is_registered():
    """The archs the port serves on the paged path, dense, VLM and (since
    the MoE slice) the two granite MoE models: the port's registry holds
    verbatim copies of the reference's configs, full size and smoke."""
    assert len(ARCHS) == 9 and "opt-13b" in ARCHS and "chameleon-34b" in ARCHS
    assert MOE_ARCHS == ["granite-moe-1b-a400m", "granite-moe-3b-a800m"]
    for name in ARCHS:
        assert dataclasses.asdict(get_smoke_config(name)) == \
            dataclasses.asdict(JAX_SMOKE[name])
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jax_config(name))


def test_registry_holds_all_twelve_archs():
    """The simulator resolves any of the reference's archs by name, so
    the port's registry holds all twelve; the five beyond ``ARCHS`` are
    verbatim copies too, full size and smoke."""
    assert sorted(CONFIGS) == sorted(JAX_CONFIGS) and len(CONFIGS) == 12
    for name in sorted(set(CONFIGS) - set(ARCHS)):
        assert dataclasses.asdict(get_smoke_config(name)) == \
            dataclasses.asdict(JAX_SMOKE[name])
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jax_config(name))


#: archs whose config, given a family that no config uses, ``build`` must
#: refuse: every family of the registry is served since the hybrid one
#: (zamba2-2.7b) was ported, so the guard is held on a name outside it
UNSERVED = ["zamba2-2.7b"]


@pytest.mark.parametrize("arch", UNSERVED)
def test_build_raises_for_families_not_served(arch):
    cfg = dataclasses.replace(get_config(arch))
    assert cfg.family in tzoo.PORTED_FAMILIES
    object.__setattr__(cfg, "family", "unregistered")   # past __post_init__
    with pytest.raises(NotImplementedError, match="is not ported"):
        tzoo.build(cfg)


@pytest.mark.parametrize("arch", ARCHS + ENCDEC_ARCHS)
def test_param_tree_matches_reference(arch):
    """``init_params`` draws the reference's tree: same keys, same
    shapes; the loaded tree has the same leaves in the same dtypes
    (the reference's fp32 tree is loaded into the bf16 model)."""
    jparams = case_pair(arch, seed=1)[1]
    want = {p: tuple(a.shape) for p, a in _leaves(jparams)}
    model = tzoo.build(case_config(arch))
    drawn = dict(_leaves(tzoo.init_params(model, seed=0, device="cpu")))
    assert {p: tuple(t.shape) for p, t in drawn.items()} == want
    loaded = dict(_leaves(params_from_jax(
        model, jax.tree.map(np.asarray, jparams), device="cpu")))
    assert {p: t.dtype for p, t in loaded.items()} == \
        {p: t.dtype for p, t in drawn.items()}
    cfg = model.cfg
    if arch in ENCDEC_ARCHS:
        # the embedding table is the unembedding too: fp32, no unembed
        assert ("unembed", "table") not in drawn
        assert drawn[("embed", "table")].dtype == torch.float32
        assert drawn[("enc_pos",)].shape == (cfg.enc_seq_len, cfg.d_model)
        assert drawn[("dec_pos",)].shape == (cfg.max_seq_len, cfg.d_model)
        assert drawn[("dec_pos",)].dtype == torch.bfloat16
        assert drawn[("dec_layers", "ln_x", "scale")].dtype == torch.float32
        assert ("dec_layers", "xattn", "wk", "b") in drawn
        assert not any("q_norm" in p for p in drawn)
        assert drawn[("enc_layers", "mlp", "up", "b")].shape == \
            (cfg.n_enc_layers, cfg.d_ff)
    elif cfg.pos_emb == "learned":
        assert drawn[("pos",)].shape == (cfg.max_seq_len, cfg.d_model)
        assert drawn[("pos",)].dtype == torch.bfloat16
        for name in ("up", "down"):
            assert ("layers", "mlp", name, "b") in drawn
    if cfg.qk_norm:
        assert drawn[("layers", "attn", "q_norm", "scale")].dtype == \
            torch.float32


@pytest.mark.parametrize("arch,impl", arch_cases(["naive", "pallas"])
                         + arch_cases(["naive", "pallas"], ENCDEC_ARCHS))
def test_forward_prefill_decode(arch, impl):
    _forward_prefill_decode(arch, attn_impl=impl)


@pytest.mark.parametrize("arch,impl", [
    pytest.param(arch, impl, id=f"{arch}-{impl}")
    for arch in MOE_ARCHS for impl in ("naive", "pallas")])
def test_forward_prefill_decode_moe_sort(arch, impl):
    _forward_prefill_decode(arch, attn_impl=impl, moe_impl="sort")


#: llama2-7b's smoke model in fp16 (the dtype of the published llama2-7b
#: checkpoint): fp16 activations, K/V and attention inputs, fp32 logits
#: (the unembedding's).  One fp16 rounding of a value near 1 is 2^-11, and
#: the two libraries round in other places, so 1e-3 (read: 2.3e-4 for
#: ``forward`` and ``prefill`` on ``naive``, 0.0 on ``pallas``, at most
#: 1.8e-7 for the decode steps; K within 6.1e-5)
FP16_TOL = 1e-3


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_forward_prefill_decode_fp16(impl):
    _forward_prefill_decode("llama2-7b", tol=FP16_TOL, dtype="float16",
                            attn_impl=impl)


def _forward_prefill_decode(arch, tol=TOL, dtype="float32", **settings):
    jmodel, params, tmodel, tparams = case_pair(arch, seed=1, dtype=dtype)
    assert tmodel.cfg.dtype == dtype
    jm = jmodel.with_settings(attn_block_q=8, attn_block_kv=8, **settings)
    tm = tmodel.with_settings(**settings)
    tokens = np.random.RandomState(0).randint(0, tm.cfg.vocab_size,
                                              size=(2, S))
    jbatch = {"tokens": jnp.asarray(tokens)}
    tbatch = {"tokens": torch.from_numpy(tokens)}
    cache_keys = ("k", "v")
    if arch in ENCDEC_ARCHS:
        embeds = frame_embeds(tm.cfg, 2)
        jbatch["embeds"] = jnp.asarray(embeds)
        tbatch["embeds"] = torch.from_numpy(embeds)
        cache_keys = ("k", "v", "xk", "xv")

    want, want_aux = FORWARD(jm, params, jbatch)
    got, got_aux = tzoo.forward(tm, tparams, tbatch)
    _close(got, want, tol)
    assert set(got_aux) == set(want_aux) == \
        ({"aux", "zloss"} if tm.cfg.family == MOE else set())
    for key in got_aux:
        _close(got_aux[key], want_aux[key], tol)

    max_len = S + 4
    jcache = jzoo.init_cache(jm, 2, max_len)
    tcache = tzoo.init_cache(tm, 2, max_len, device="cpu")
    want, jcache = PREFILL(jm, params, jbatch, jcache)
    got, tcache = tzoo.prefill(tm, tparams, tbatch, tcache)
    _close(got, want, tol)
    assert set(tcache) == set(jcache) == set(cache_keys) | {"len"}
    for key in cache_keys:
        _close(tcache[key], jcache[key], tol)
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()

    tok = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)
    for _ in range(3):
        want, jcache = DECODE(jm, params, jcache, jnp.asarray(tok))
        got, tcache = tzoo.decode_step(tm, tparams, tcache,
                                       torch.from_numpy(tok.astype(np.int64)))
        _close(got, want, tol)
        tok = np.asarray(jnp.argmax(want, -1), np.int32)
    for key in cache_keys:
        _close(tcache[key], jcache[key], tol)


@pytest.mark.parametrize("arch", ["llama2-7b", "whisper-base",
                                  "zamba2-2.7b"])
def test_decode_past_the_cache_end_drops_the_write(arch):
    """A row whose length is the cache's (as an empty slot's comes to be,
    advancing every decode step) writes no K/V, as the reference's
    ``.at[].set`` drops an index past the end (torch indexing would
    raise), and attends to the whole cache; the other row decodes as
    usual."""
    jm, params, tm, tparams = case_pair(arch, seed=3)
    tokens = np.random.RandomState(4).randint(0, tm.cfg.vocab_size,
                                              size=(2, S))
    jbatch = {"tokens": jnp.asarray(tokens)}
    tbatch = {"tokens": torch.from_numpy(tokens)}
    if arch in ENCDEC_ARCHS:
        embeds = frame_embeds(tm.cfg, 2, seed=5)
        jbatch["embeds"] = jnp.asarray(embeds)
        tbatch["embeds"] = torch.from_numpy(embeds)
    jcache = jzoo.init_cache(jm, 2, S + 1)
    tcache = tzoo.init_cache(tm, 2, S + 1, device="cpu")
    _, jcache = PREFILL(jm, params, jbatch, jcache)
    tzoo.prefill(tm, tparams, tbatch, tcache)
    lens = np.array([S, S + 1], np.int32)     # row 1: past the end
    jcache["len"] = jnp.asarray(lens)
    tcache["len"].copy_(torch.from_numpy(lens))
    tok = np.array([3, 5], np.int32)
    want, jcache = DECODE(jm, params, jcache, jnp.asarray(tok))
    got, tcache = tzoo.decode_step(tm, tparams, tcache,
                                   torch.from_numpy(tok.astype(np.int64)))
    _close(got, want)
    for key in set(tcache) - {"len"}:
        _close(tcache[key], jcache[key])
    assert tcache["len"].tolist() == [S + 1, S + 2]


#: opt with a position table of 24 rows, prefilled with 20 tokens and
#: decoded to position 27
SHORT_POS = 24
SHORT_PROMPT = 20


def test_learned_positions_past_the_table():
    jm, params, tm, tparams = model_pair("opt-13b", seed=2,
                                         max_seq_len=SHORT_POS)
    assert tparams["pos"].shape[0] == SHORT_POS
    tokens = np.random.RandomState(3).randint(0, tm.cfg.vocab_size,
                                              size=(2, SHORT_PROMPT))
    jcache = jzoo.init_cache(jm, 2, 32)
    tcache = tzoo.init_cache(tm, 2, 32, device="cpu")
    want, jcache = PREFILL(jm, params, {"tokens": jnp.asarray(tokens)},
                           jcache)
    got, tcache = tzoo.prefill(tm, tparams,
                               {"tokens": torch.from_numpy(tokens)}, tcache)
    _close(got, want)
    tok = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)
    for _ in range(SHORT_POS + 4 - SHORT_PROMPT):     # positions 20 .. 27
        want, jcache = DECODE(jm, params, jcache, jnp.asarray(tok))
        got, tcache = tzoo.decode_step(tm, tparams, tcache,
                                       torch.from_numpy(tok.astype(np.int64)))
        _close(got, want)
        tok = np.asarray(jnp.argmax(want, -1), np.int32)
    assert tcache["len"].tolist() == [SHORT_POS + 4] * 2


def test_param_layout():
    """bf16 compute: matmul weights in bf16, norms and the unembedding
    table in fp32, as ``params_from_jax`` and ``init_params`` agree."""
    _, params, _, _ = model_pair("llama2-7b", seed=1)
    cfg = get_smoke_config("llama2-7b")
    model = tzoo.build(cfg)
    loaded = params_from_jax(model, jax.tree.map(np.asarray, params),
                             device="cpu")
    drawn = tzoo.init_params(model, seed=0, device="cpu")

    a, b = dict(_leaves(loaded)), dict(_leaves(drawn))
    assert a.keys() == b.keys()
    for path, t in a.items():
        assert t.shape == b[path].shape and t.dtype == b[path].dtype, path
    assert a[("layers", "attn", "wq", "w")].dtype == torch.bfloat16
    assert a[("embed", "table")].dtype == torch.bfloat16
    assert a[("unembed", "table")].dtype == torch.float32
    assert a[("layers", "ln1", "scale")].dtype == torch.float32
    assert len(jax.tree.leaves(params)) == len(a)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_layout(arch):
    """bf16 compute: the router in fp32 (its reader computes in fp32),
    the experts' up/gate/down in bf16, stacked (L, E, ...), as
    ``params_from_jax`` and ``init_params`` agree."""
    _, params, _, _ = model_pair(arch, seed=1)
    model = tzoo.build(get_smoke_config(arch))
    cfg = model.cfg
    e, d, f = model.plan.n_experts, cfg.d_model, cfg.moe.d_expert
    loaded = dict(_leaves(params_from_jax(
        model, jax.tree.map(np.asarray, params), device="cpu")))
    drawn = dict(_leaves(tzoo.init_params(model, seed=0, device="cpu")))
    for tree in (loaded, drawn):
        assert ("layers", "mlp", "up", "w") not in tree
        router = tree[("layers", "moe", "router")]
        assert router.dtype == torch.float32
        assert router.shape == (cfg.num_layers, d, e)
        for name, shape in (("up", (e, d, f)), ("gate", (e, d, f)),
                            ("down", (e, f, d))):
            leaf = tree[("layers", "moe", name)]
            assert leaf.dtype == torch.bfloat16, name
            assert leaf.shape == (cfg.num_layers,) + shape, name
