"""repro_torch.models.moe against repro.models.moe, fp32 on the CPU.

Parameters are drawn by the reference's ``moe_init`` and loaded with
``params_from_jax`` (under an fp32 granite smoke model, whose router
path is stored in fp32 anyway); inputs come from numpy with a seed.
Both of the port's routes (``dense_onehot``, ``sort``) are held to the
reference's functions: the output and the ``aux`` and ``zloss`` values,
tolerance 1e-5 (fp32, the same formulas, the libraries summing in
other orders).  Cases: gated (SiLU) and plain (GELU) experts, padded
experts (``n_experts_logical < n_experts``, which take -1e30 router
logits), and 1, 7 and 64 tokens.  The port's two routes agree with each
other to the same tolerance, and a padded row of a decode batch, whatever
it holds, leaves the live rows' outputs unchanged (token choice has no
capacity).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = 1e-5
D_MODEL, D_EXPERT, TOP_K = 32, 24, 2
#: (act, n_experts, n_experts_logical)
VARIANTS = {"silu": ("silu", 5, 5), "gelu": ("gelu", 5, 5),
            "silu-padded": ("silu", 6, 4), "gelu-padded": ("gelu", 8, 5)}
ROUTES = {"dense_onehot": (jmoe.moe_apply_dense, tmoe.moe_apply_dense),
          "sort": (jmoe.moe_apply_sort, tmoe.moe_apply_sort)}
_FP32_MODEL = tzoo.build(dataclasses.replace(
    get_smoke_config("granite-moe-1b-a400m"), dtype="float32"))


def _params(variant, seed=0):
    act, n_exp, n_log = VARIANTS[variant]
    jp = jmoe.moe_init(jax.random.key(seed), D_MODEL, n_exp, D_EXPERT, act,
                       jnp.float32)
    tp = params_from_jax(_FP32_MODEL, {"moe": jax.tree.map(np.asarray, jp)},
                         device="cpu")["moe"]
    return jp, tp, n_log


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("tokens", [1, 7, 64])
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_matches_reference(variant, route, tokens):
    jp, tp, n_log = _params(variant)
    jfn, tfn = ROUTES[route]
    x = _x((tokens, D_MODEL))
    kw = dict(top_k=TOP_K, n_experts_logical=n_log)
    want, want_aux = jfn(jp, jnp.asarray(x), compute_dtype=jnp.float32,
                         **kw)
    got, got_aux = tfn(tp, torch.from_numpy(x),
                       compute_dtype=torch.float32, **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)
    assert set(got_aux) == set(want_aux) == {"aux", "zloss"}
    for key in ("aux", "zloss"):
        _close(got_aux[key], want_aux[key])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_routes_agree(variant):
    """The port's two routes on the same (B, S, d) input, through
    ``moe_apply``."""
    _, tp, n_log = _params(variant, seed=2)
    x = torch.from_numpy(_x((3, 11, D_MODEL), seed=3))
    out = {impl: tmoe.moe_apply(tp, x, top_k=TOP_K, n_experts_logical=n_log,
                                impl=impl, compute_dtype=torch.float32)
           for impl in ROUTES}
    (a, a_aux), (b, b_aux) = out["dense_onehot"], out["sort"]
    _close(a, b.numpy())
    for key in ("aux", "zloss"):
        _close(a_aux[key], b_aux[key].numpy())


def test_padded_experts_take_no_tokens():
    """A padded expert is never chosen, and its weights, whatever they
    hold, do not reach the output."""
    _, tp, n_log = _params("silu-padded", seed=4)
    x = torch.from_numpy(_x((64, D_MODEL), seed=5))
    probs, ids, _ = tmoe._router(tp, x, TOP_K, n_log)
    assert int(ids.max()) < n_log
    torch.testing.assert_close(probs.sum(-1), torch.ones(64))
    poisoned = {k: v.clone() for k, v in tp.items()}
    for k in ("up", "gate", "down"):
        poisoned[k][n_log:] = 1e3
    for impl in ROUTES:
        kw = dict(top_k=TOP_K, n_experts_logical=n_log, impl=impl,
                  compute_dtype=torch.float32)
        _close(tmoe.moe_apply(poisoned, x, **kw)[0],
               tmoe.moe_apply(tp, x, **kw)[0].numpy())


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_padded_decode_row_leaves_live_rows_unchanged(route):
    """A decode batch (B, 1, d) whose last row is padding: live rows'
    outputs are those of the live rows alone, whether the padded row is
    zeros or large values that route elsewhere."""
    _, tp, n_log = _params("silu", seed=6)
    live = _x((5, 1, D_MODEL), seed=7)
    kw = dict(top_k=TOP_K, n_experts_logical=n_log, impl=route,
              compute_dtype=torch.float32)
    alone, _ = tmoe.moe_apply(tp, torch.from_numpy(live), **kw)
    for pad in (np.zeros((1, 1, D_MODEL), np.float32),
                100 * _x((1, 1, D_MODEL), seed=8)):
        batch = torch.from_numpy(np.concatenate([live, pad]))
        got, _ = tmoe.moe_apply(tp, batch, **kw)
        _close(got[:5], alone.numpy())


def test_unknown_route_raises():
    _, tp, n_log = _params("silu")
    with pytest.raises(ValueError, match="unknown moe impl"):
        tmoe.moe_apply(tp, torch.zeros(2, D_MODEL), top_k=TOP_K,
                       n_experts_logical=n_log, impl="capacity",
                       compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="unknown moe impl"):
        tzoo.RunSettings(moe_impl="capacity")
