"""repro_torch.models.ssm and the SSM family of model_zoo against the
reference, on the CPU.

Inputs come from numpy with fixed seeds and go through both; parameters
are the reference's, loaded with ``params_from_jax``.  Tolerances: 1e-5
for the functions of ``ssm.py`` in fp32 (same formulas, other libraries'
summation order), 1e-4 for the two-layer smoke model in fp32 (forward,
prefill states, decode steps).  On CPU tensors ``ssd_chunked`` runs the
SSD kernel's plain version, the chunked formula.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = 1e-5
MODEL_TOL = 1e-4
ARCH = "mamba2-130m"


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _ssd_inputs(b, s, h, p, g, n, seed=0):
    rng = np.random.RandomState(seed)
    xbar = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)
    dA_log = (-dt * np.exp(rng.uniform(size=(1, 1, h)))).astype(np.float32)
    Bm = rng.randn(b, s, g, n).astype(np.float32)
    Cm = rng.randn(b, s, g, n).astype(np.float32)
    state0 = rng.randn(b, h, n, p).astype(np.float32)
    return xbar, dA_log, Bm, Cm, state0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_recurrent_and_chunked(with_state):
    xbar, dA_log, Bm, Cm, s0 = _ssd_inputs(2, 64, 4, 8, 2, 16)
    js0 = jnp.asarray(s0) if with_state else None
    ts0 = torch.from_numpy(s0) if with_state else None
    for jfn, tfn in ((lambda *a: jssm.ssd_recurrent(*a, state0=js0),
                      lambda *a: tssm.ssd_recurrent(*a, state0=ts0)),
                     (lambda *a: jssm.ssd_chunked(*a, 16, state0=js0),
                      lambda *a: tssm.ssd_chunked(*a, 16, state0=ts0))):
        yw, fw = jfn(*_j(xbar, dA_log, Bm, Cm))
        y, f = tfn(*_t(xbar, dA_log, Bm, Cm))
        _close(y, yw)
        _close(f, fw)


def test_ssd_chunked_rejects_ragged_sequence():
    xbar, dA_log, Bm, Cm, _ = _ssd_inputs(1, 40, 2, 8, 1, 16)
    with pytest.raises(ValueError, match="divisible"):
        tssm.ssd_chunked(*_t(xbar, dA_log, Bm, Cm), 16)


def test_ssd_step():
    xbar, dA_log, Bm, Cm, s0 = _ssd_inputs(3, 1, 4, 8, 2, 16, seed=1)
    yw, fw = jssm.ssd_step(*_j(s0, xbar[:, 0], dA_log[:, 0], Bm[:, 0],
                               Cm[:, 0]))
    y, f = tssm.ssd_step(*_t(s0, xbar[:, 0], dA_log[:, 0], Bm[:, 0],
                             Cm[:, 0]))
    _close(y, yw)
    _close(f, fw)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_and_step(with_state):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 12).astype(np.float32)
    w = rng.randn(4, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    st = rng.randn(2, 3, 12).astype(np.float32)
    jst = jnp.asarray(st) if with_state else None
    tst = torch.from_numpy(st) if with_state else None
    yw, sw = jssm.causal_conv1d(*_j(x, w, b), jst)
    y, s = tssm.causal_conv1d(*_t(x, w, b), tst)
    _close(y, yw)
    _close(s, sw)
    yw, sw = jssm.conv_step(*_j(x[:, 0], w, b, st))
    y, s = tssm.conv_step(*_t(x[:, 0], w, b, st))
    _close(y, yw)
    _close(s, sw)


@pytest.fixture(scope="module")
def mixer():
    """One Mamba2 mixer of the fp32 smoke config, reference parameters."""
    cfg = jax_smoke(ARCH)
    p = jssm.mamba2_init(jax.random.key(3), cfg.d_model, cfg.ssm,
                         jnp.float32)
    return cfg, p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("s", [64, 40], ids=["chunked", "recurrent"])
def test_mamba2_apply_then_decode(mixer, s):
    """S 64 is a multiple of the chunk (32) and takes ``ssd_chunked``;
    S 40 is not and takes ``ssd_recurrent``.  Two decode steps follow
    from the prefill's states."""
    cfg, jp, tp = mixer
    x = np.random.RandomState(4).randn(2, s, cfg.d_model).astype(np.float32)
    kw = dict(compute_dtype=jnp.float32)
    want, (jcs, jss) = jssm.mamba2_apply(jp, jnp.asarray(x), cfg.ssm, **kw)
    got, (tcs, tss) = tssm.mamba2_apply(tp, torch.from_numpy(x), cfg.ssm,
                                        compute_dtype=torch.float32)
    _close(got, want)
    _close(tcs, jcs)
    _close(tss, jss)
    for t in range(2):
        xt = np.random.RandomState(5 + t).randn(2, cfg.d_model) \
            .astype(np.float32)
        want, (jcs, jss) = jssm.mamba2_decode(
            jp, jnp.asarray(xt), cfg.ssm, conv_state=jcs, ssd_state=jss,
            **kw)
        got, (tcs, tss) = tssm.mamba2_decode(
            tp, torch.from_numpy(xt), cfg.ssm, compute_dtype=torch.float32,
            conv_state=tcs, ssd_state=tss)
        _close(got, want)
        _close(tss, jss)


def test_mamba2_apply_impl_recurrent_matches_chunked(mixer):
    """``impl="recurrent"`` is the reference's own switch; at S 64 both
    routes compute the same block."""
    cfg, _, tp = mixer
    x = torch.from_numpy(np.random.RandomState(6).randn(1, 64, cfg.d_model)
                         .astype(np.float32))
    a, (_, sa) = tssm.mamba2_apply(tp, x, cfg.ssm,
                                   compute_dtype=torch.float32)
    b, (_, sb) = tssm.mamba2_apply(tp, x, cfg.ssm,
                                   compute_dtype=torch.float32,
                                   impl="recurrent")
    _close(a, b)
    _close(sa, sb)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jmodel = jzoo.build(jcfg)
    params = jzoo.init_params(jmodel, jax.random.key(1))
    tmodel = tzoo.build(tcfg)
    tparams = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              device="cpu")
    return jmodel, params, tmodel, tparams


@pytest.mark.parametrize("s", [64, 24], ids=["chunked", "recurrent"])
def test_forward_prefill_decode(pair, s):
    jm, params, tm, tparams = pair
    tokens = np.random.RandomState(0).randint(0, tm.cfg.vocab_size,
                                              size=(2, s))
    want, _ = jzoo.forward(jm, params, {"tokens": jnp.asarray(tokens)})
    got, _ = tzoo.forward(tm, tparams, {"tokens": torch.from_numpy(tokens)})
    _close(got, want, MODEL_TOL)

    jcache = jzoo.init_cache(jm, 2, s + 4)
    tcache = tzoo.init_cache(tm, 2, s + 4, device="cpu")
    want, jcache = jzoo.prefill(jm, params, {"tokens": jnp.asarray(tokens)},
                                jcache)
    got, tcache = tzoo.prefill(tm, tparams,
                               {"tokens": torch.from_numpy(tokens)}, tcache)
    _close(got, want, MODEL_TOL)
    for key in ("conv", "ssd"):
        _close(tcache[key], jcache[key], MODEL_TOL)
    tok = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)
    for _ in range(3):
        want, jcache = jzoo.decode_step(jm, params, jcache, jnp.asarray(tok))
        got, tcache = tzoo.decode_step(tm, tparams, tcache,
                                       torch.from_numpy(tok.astype(np.int64)))
        _close(got, want, MODEL_TOL)
        tok = np.asarray(jnp.argmax(want, -1), np.int32)
    for key in ("conv", "ssd"):
        _close(tcache[key], jcache[key], MODEL_TOL)
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()


MIXER_FP32 = ("A_log", "D", "dt_bias", "norm_scale", "conv_w", "conv_b")


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_param_storage_dtypes(pair):
    """bf16 compute: the six mixer leaves the reference reads in fp32 are
    stored in fp32, ``in_proj``/``out_proj`` in bf16; the tied embedding
    table is fp32 and there is no ``unembed``.  ``params_from_jax`` and
    ``init_params`` agree on every leaf."""
    _, params, _, _ = pair
    model = tzoo.build(get_smoke_config(ARCH))
    for leaf in MIXER_FP32:
        assert tzoo.param_dtype(model, ("layers", "mixer", leaf)) \
            == torch.float32, leaf
    for leaf in ("in_proj", "out_proj"):
        assert tzoo.param_dtype(model, ("layers", "mixer", leaf)) \
            == torch.bfloat16, leaf
    loaded = dict(_leaves(params_from_jax(
        model, jax.tree.map(np.asarray, params), device="cpu")))
    drawn = dict(_leaves(tzoo.init_params(model, seed=0, device="cpu")))
    assert loaded.keys() == drawn.keys()
    assert ("unembed", "table") not in loaded
    assert loaded[("embed", "table")].dtype == torch.float32
    for path, t in loaded.items():
        assert t.shape == drawn[path].shape and t.dtype == drawn[path].dtype
        assert t.dtype == (torch.float32 if path[-1] in MIXER_FP32 + (
            "scale", "table") else torch.bfloat16), path


#: bf16 smoke model, port vs reference logits: relative L2 error (the
#: norm of the difference over the norm of the reference's logits).
#: Readings on the four prompts below: the port as it stores its leaves
#: 4.3e-4; the same weights with the six mixer leaves stored in bf16
#: instead 7.5e-3.  The limit lies between them.
BF16_LOGIT_TOL = 2e-3


def test_bf16_logits_need_fp32_mixer_leaves():
    """The bf16-compute smoke model (reference weights, fp32 master
    copies on the JAX side) gives the reference's logits within
    BF16_LOGIT_TOL; storing the six fp32 mixer leaves in bf16 instead
    breaks that limit."""
    jmodel = jzoo.build(jax_smoke(ARCH))
    params = jzoo.init_params(jmodel, jax.random.key(2))
    tmodel = tzoo.build(get_smoke_config(ARCH))
    tparams = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              device="cpu")
    tokens = np.random.RandomState(7).randint(0, 256, size=(4, 64))
    want, _ = jzoo.forward(jmodel, params, {"tokens": jnp.asarray(tokens)})
    want = np.asarray(want, np.float32)

    def rel_l2(tp):
        got, _ = tzoo.forward(tmodel, tp, {"tokens": torch.from_numpy(tokens)})
        return float(np.linalg.norm(got.float().numpy() - want)
                     / np.linalg.norm(want))

    mixer = tparams["layers"]["mixer"]
    rounded = dict(tparams, layers=dict(tparams["layers"], mixer={
        k: v.to(torch.bfloat16) if k in MIXER_FP32 else v
        for k, v in mixer.items()}))
    sound, bf16_leaves = rel_l2(tparams), rel_l2(rounded)
    print(f"\nbf16 logits vs reference, relative L2: fp32 leaves "
          f"{sound:.3e}, bf16 leaves {bf16_leaves:.3e}, limit "
          f"{BF16_LOGIT_TOL}")
    assert sound <= BF16_LOGIT_TOL < bf16_leaves
