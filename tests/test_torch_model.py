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
FORWARD = jax.jit(jzoo.forward, static_argnums=0)
PREFILL = jax.jit(jzoo.prefill, static_argnums=0)
DECODE = jax.jit(jzoo.decode_step, static_argnums=0)
TOL = 1e-4
S = 24


def arch_cases(impls):
    """(arch, impl) cases of every arch; llama2-7b's ids are the impl
    alone, as they were when it was the only arch."""
    return [pytest.param(arch, impl,
                         id=impl if arch == "llama2-7b" else f"{arch}-{impl}")
            for arch in ARCHS for impl in impls]


@functools.lru_cache(maxsize=None)
def model_pair(arch, seed=0, **overrides):
    """The reference's fp32 smoke model and its weights, and the port's
    with the same weights loaded; made once per arguments (no test
    writes into the weights)."""
    jcfg = dataclasses.replace(JAX_SMOKE[arch], dtype="float32",
                               **overrides)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
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


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


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


#: archs whose families the port registers for the simulator's cost model
#: but does not serve (hybrid, audio), and an encoder-decoder
UNSERVED = ["zamba2-2.7b", "whisper-base", "whisper-base-as-encdec"]


@pytest.mark.parametrize("arch", UNSERVED)
def test_build_raises_for_families_not_served(arch):
    if arch.endswith("-as-encdec"):
        cfg = dataclasses.replace(get_config("whisper-base"), family=ENCDEC)
    else:
        cfg = get_config(arch)
    assert cfg.family not in tzoo.PORTED_FAMILIES
    with pytest.raises(NotImplementedError, match="is not ported"):
        tzoo.build(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """``init_params`` draws the reference's tree: same keys, same
    shapes; the loaded tree has the same leaves in the same dtypes
    (the reference's fp32 tree is loaded into the bf16 model)."""
    jparams = model_pair(arch, seed=1)[1]
    want = {p: tuple(a.shape) for p, a in _leaves(jparams)}
    model = tzoo.build(get_smoke_config(arch))
    drawn = dict(_leaves(tzoo.init_params(model, seed=0, device="cpu")))
    assert {p: tuple(t.shape) for p, t in drawn.items()} == want
    loaded = dict(_leaves(params_from_jax(
        model, jax.tree.map(np.asarray, jparams), device="cpu")))
    assert {p: t.dtype for p, t in loaded.items()} == \
        {p: t.dtype for p, t in drawn.items()}
    cfg = model.cfg
    if cfg.pos_emb == "learned":
        assert drawn[("pos",)].shape == (cfg.max_seq_len, cfg.d_model)
        assert drawn[("pos",)].dtype == torch.bfloat16
        for name in ("up", "down"):
            assert ("layers", "mlp", name, "b") in drawn
    if cfg.qk_norm:
        assert drawn[("layers", "attn", "q_norm", "scale")].dtype == \
            torch.float32


@pytest.mark.parametrize("arch,impl", arch_cases(["naive", "pallas"]))
def test_forward_prefill_decode(arch, impl):
    _forward_prefill_decode(arch, attn_impl=impl)


@pytest.mark.parametrize("arch,impl", [
    pytest.param(arch, impl, id=f"{arch}-{impl}")
    for arch in MOE_ARCHS for impl in ("naive", "pallas")])
def test_forward_prefill_decode_moe_sort(arch, impl):
    _forward_prefill_decode(arch, attn_impl=impl, moe_impl="sort")


def _forward_prefill_decode(arch, **settings):
    jmodel, params, tmodel, tparams = model_pair(arch, seed=1)
    jm = jmodel.with_settings(attn_block_q=8, attn_block_kv=8, **settings)
    tm = tmodel.with_settings(**settings)
    tokens = np.random.RandomState(0).randint(0, tm.cfg.vocab_size,
                                              size=(2, S))

    want, want_aux = FORWARD(jm, params, {"tokens": jnp.asarray(tokens)})
    got, got_aux = tzoo.forward(tm, tparams,
                                {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    assert set(got_aux) == set(want_aux) == \
        ({"aux", "zloss"} if tm.cfg.family == MOE else set())
    for key in got_aux:
        _close(got_aux[key], want_aux[key])

    max_len = S + 4
    jcache = jzoo.init_cache(jm, 2, max_len)
    tcache = tzoo.init_cache(tm, 2, max_len, device="cpu")
    want, jcache = PREFILL(jm, params, {"tokens": jnp.asarray(tokens)},
                           jcache)
    got, tcache = tzoo.prefill(tm, tparams,
                               {"tokens": torch.from_numpy(tokens)}, tcache)
    _close(got, want)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()

    tok = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)
    for _ in range(3):
        want, jcache = DECODE(jm, params, jcache, jnp.asarray(tok))
        got, tcache = tzoo.decode_step(tm, tparams, tcache,
                                       torch.from_numpy(tok.astype(np.int64)))
        _close(got, want)
        tok = np.asarray(jnp.argmax(want, -1), np.int32)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])


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
