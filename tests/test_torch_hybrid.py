"""The HYBRID family (zamba2) of repro_torch.models.model_zoo against the
reference, on the CPU.

zamba2-2.7b's smoke config (4 Mamba2 layers in 2 groups, each group
followed by the shared transformer block, 4 heads of 16) is made in
fp32 by the reference and loaded into the port with ``params_from_jax``;
so is a narrow hybrid config with head_dim 80 (``NARROW_80``: d_model
160, 2 heads of 80, 2 groups), the width of zamba2-2.7b's shared block,
which the smoke config never reaches.  Inputs are token ids drawn with
numpy.  Both hold, to 1e-4 (fp32 through the layers; the libraries sum
in other orders):

* ``forward`` logits;
* ``prefill`` logits and every cache array (``conv`` and ``ssd`` of
  every layer, ``k`` and ``v`` of every application of the shared
  block), at a prompt length that is a multiple of the SSD chunk (the
  chunked scan, the SSD kernel's route) and at one that is not (the
  recurrent scan);
* three ``decode_step``s, and the caches after them;

once with the naive attention and once with ``pallas``: the Pallas
flash kernel in interpret mode on the reference side (at head_dim 80 its
wrapper pads nothing in interpret mode), the flash kernel's plain
version on the port's.

The shared block's copy: with two copies (``n_shared_attn=2``), the
reference's ``forward`` takes them in turn and its ``prefill`` and
``decode_step`` take copy 0 (model_zoo.py:537-538, 726, 814); the port
mirrors both, so its ``forward`` and ``prefill`` logits differ as the
reference's do.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import HYBRID, SSMConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402

ARCH = "zamba2-2.7b"
TOL = 1e-4
#: the narrow head_dim-80 hybrid: zamba2's smoke config at d_model 160
#: with 2 heads (head_dim 80); its SSD keeps the smoke chunk (32)
NARROW_80 = dict(d_model=160, n_heads=2, n_kv_heads=2, head_dim=80,
                 d_ff=320,
                 ssm=SSMConfig(d_state=16, head_dim=16, expand=2,
                               conv_width=4, chunk_size=32, n_groups=1))
CONFIGS = {"smoke": {}, "head_dim_80": NARROW_80,
           "two_copies": {"n_shared_attn": 2}}
#: prompt lengths: 64 is a multiple of the chunk (chunked scan), 24 is not
LENGTHS = {"chunked": 64, "recurrent": 24}


@functools.lru_cache(maxsize=None)
def pair(config, seed=1):
    """The reference's fp32 hybrid model and weights, and the port's with
    the same weights."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32",
                               **CONFIGS[config])
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                               **CONFIGS[config])
    jmodel = jzoo.build(jcfg)
    params = jzoo.init_params(jmodel, jax.random.key(seed))
    tmodel = tzoo.build(tcfg)
    tparams = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              device="cpu")
    return jmodel, params, tmodel, tparams


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_configs_are_hybrid_at_the_widths_named():
    assert tzoo.build(get_smoke_config(ARCH)).cfg.family == HYBRID
    assert HYBRID in tzoo.PORTED_FAMILIES
    tm = pair("head_dim_80")[2]
    assert tm.cfg.head_dim == 80 and tzoo._hybrid_groups(tm) == (2, 2)
    assert tzoo._hybrid_groups(pair("smoke")[2]) == (2, 2)


@pytest.mark.parametrize("config", ["smoke", "head_dim_80"])
def test_param_tree_matches_reference(config):
    """``init_params`` draws the reference's tree (``shared_attn`` stacked
    over the copies, the untied ``unembed``), and ``params_from_jax``
    loads it into the bf16 model with nothing new: each leaf's storage
    dtype follows from its path."""
    _, jparams, tmodel, _ = pair(config)
    model = tzoo.build(dataclasses.replace(tmodel.cfg, dtype="bfloat16"))
    want = {p: tuple(a.shape) for p, a in _leaves(jparams)}
    drawn = dict(_leaves(tzoo.init_params(model, seed=0, device="cpu")))
    loaded = dict(_leaves(params_from_jax(
        model, jax.tree.map(np.asarray, jparams), device="cpu")))
    assert {p: tuple(t.shape) for p, t in drawn.items()} == want
    assert {p: tuple(t.shape) for p, t in loaded.items()} == want
    assert {p: t.dtype for p, t in loaded.items()} == \
        {p: t.dtype for p, t in drawn.items()}
    cfg = model.cfg
    assert drawn[("shared_attn", "attn", "wq", "w")].shape == \
        (cfg.n_shared_attn, cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert drawn[("shared_attn", "attn", "wq", "w")].dtype == torch.bfloat16
    assert drawn[("shared_attn", "ln1", "scale")].dtype == torch.float32
    assert drawn[("layers", "mixer", "A_log")].dtype == torch.float32
    assert drawn[("layers", "mixer", "in_proj")].dtype == torch.bfloat16
    assert drawn[("unembed", "table")].dtype == torch.float32


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("length", sorted(LENGTHS))
@pytest.mark.parametrize("config", ["smoke", "head_dim_80"])
def test_forward_prefill_decode(config, length, impl):
    jmodel, params, tmodel, tparams = pair(config)
    jm = jmodel.with_settings(attn_impl=impl, attn_block_q=8,
                              attn_block_kv=8)
    tm = tmodel.with_settings(attn_impl=impl)
    s = LENGTHS[length]
    tokens = np.random.RandomState(0).randint(0, tm.cfg.vocab_size,
                                              size=(2, s))
    jbatch = {"tokens": jnp.asarray(tokens)}
    tbatch = {"tokens": torch.from_numpy(tokens)}
    want, _ = jzoo.forward(jm, params, jbatch)
    got, aux = tzoo.forward(tm, tparams, tbatch)
    _close(got, want)
    assert aux == {}

    jcache = jzoo.init_cache(jm, 2, s + 4)
    tcache = tzoo.init_cache(tm, 2, s + 4, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    assert tcache["k"].shape[0] == tzoo._hybrid_groups(tm)[0]
    want, jcache = jzoo.prefill(jm, params, jbatch, jcache)
    got, tcache = tzoo.prefill(tm, tparams, tbatch, tcache)
    _close(got, want)
    keys = sorted(set(tcache) - {"len"})
    assert keys == ["conv", "k", "ssd", "v"]
    for key in keys:
        _close(tcache[key], jcache[key])
    assert tcache["len"].tolist() == [s, s]

    tok = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)
    for _ in range(3):
        want, jcache = jzoo.decode_step(jm, params, jcache, jnp.asarray(tok))
        got, tcache = tzoo.decode_step(tm, tparams, tcache,
                                       torch.from_numpy(tok.astype(np.int64)))
        _close(got, want)
        tok = np.asarray(jnp.argmax(want, -1), np.int32)
    for key in keys:
        _close(tcache[key], jcache[key])
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()


def test_shared_copy_rule_mirrors_the_reference():
    """Two copies of the shared block: ``forward`` takes copy g % 2 for
    application g, ``prefill`` and ``decode_step`` copy 0, in both
    packages; the two entry points' logits therefore differ."""
    jm, params, tm, tparams = pair("two_copies")
    assert tparams["shared_attn"]["attn"]["wq"]["w"].shape[0] == 2
    tokens = np.random.RandomState(2).randint(0, tm.cfg.vocab_size,
                                              size=(2, 32))
    jbatch = {"tokens": jnp.asarray(tokens)}
    tbatch = {"tokens": torch.from_numpy(tokens)}
    want_fwd, _ = jzoo.forward(jm, params, jbatch)
    got_fwd, _ = tzoo.forward(tm, tparams, tbatch)
    _close(got_fwd, want_fwd)
    want_pre, jcache = jzoo.prefill(jm, params, jbatch,
                                    jzoo.init_cache(jm, 2, 36))
    got_pre, tcache = tzoo.prefill(tm, tparams, tbatch,
                                   tzoo.init_cache(tm, 2, 36, device="cpu"))
    _close(got_pre, want_pre)
    assert np.abs(np.asarray(want_fwd) - np.asarray(want_pre)).max() > 1e-2
    tok = np.asarray(jnp.argmax(want_pre[:, -1], -1), np.int32)
    want, _ = jzoo.decode_step(jm, params, jcache, jnp.asarray(tok))
    got, _ = tzoo.decode_step(tm, tparams, tcache,
                              torch.from_numpy(tok.astype(np.int64)))
    _close(got, want)
