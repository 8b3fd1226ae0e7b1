"""repro_torch.models.model_zoo against repro.models.model_zoo.

The reference's llama2-7b smoke model in fp32, its parameters made by
the reference and loaded with ``params_from_jax``; ``forward`` logits,
``prefill`` logits and KV, and three ``decode_step``s compared with
tolerance 1e-4 (fp32 through two layers; the libraries sum in other
orders).  Once with the naive attention and once with ``pallas``, which
is the Pallas kernel in interpret mode on the reference side and the
flash kernel's plain version on the port's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402

TOL = 1e-4
S = 24


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_smoke("llama2-7b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama2-7b"),
                               dtype="float32")
    jmodel = jzoo.build(jcfg)
    params = jzoo.init_params(jmodel, jax.random.key(1))
    tparams = params_from_jax(tzoo.build(tcfg),
                              jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, tcfg, jmodel, params, tparams


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_forward_prefill_decode(pair, impl):
    jcfg, tcfg, jmodel, params, tparams = pair
    jm = jmodel.with_settings(attn_impl=impl, attn_block_q=8,
                              attn_block_kv=8)
    tm = tzoo.build(tcfg).with_settings(attn_impl=impl)
    tokens = np.random.RandomState(0).randint(0, tcfg.vocab_size,
                                              size=(2, S))

    want, _ = jzoo.forward(jm, params, {"tokens": jnp.asarray(tokens)})
    got, _ = tzoo.forward(tm, tparams, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)

    max_len = S + 4
    jcache = jzoo.init_cache(jm, 2, max_len)
    tcache = tzoo.init_cache(tm, 2, max_len, device="cpu")
    want, jcache = jzoo.prefill(jm, params, {"tokens": jnp.asarray(tokens)},
                                jcache)
    got, tcache = tzoo.prefill(tm, tparams,
                               {"tokens": torch.from_numpy(tokens)}, tcache)
    _close(got, want)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()

    tok = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)
    for _ in range(3):
        want, jcache = jzoo.decode_step(jm, params, jcache, jnp.asarray(tok))
        got, tcache = tzoo.decode_step(tm, tparams, tcache,
                                       torch.from_numpy(tok.astype(np.int64)))
        _close(got, want)
        tok = np.asarray(jnp.argmax(want, -1), np.int32)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])


def test_param_layout(pair):
    """bf16 compute: matmul weights in bf16, norms and the unembedding
    table in fp32, as ``params_from_jax`` and ``init_params`` agree."""
    jcfg, tcfg, jmodel, params, _ = pair
    cfg = get_smoke_config("llama2-7b")
    model = tzoo.build(cfg)
    loaded = params_from_jax(model, jax.tree.map(np.asarray, params),
                             device="cpu")
    drawn = tzoo.init_params(model, seed=0, device="cpu")

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v

    a, b = dict(leaves(loaded)), dict(leaves(drawn))
    assert a.keys() == b.keys()
    for path, t in a.items():
        assert t.shape == b[path].shape and t.dtype == b[path].dtype, path
    assert a[("layers", "attn", "wq", "w")].dtype == torch.bfloat16
    assert a[("embed", "table")].dtype == torch.bfloat16
    assert a[("unembed", "table")].dtype == torch.float32
    assert a[("layers", "ln1", "scale")].dtype == torch.float32
    assert len(jax.tree.leaves(params)) == len(a)
