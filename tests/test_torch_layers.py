"""repro_torch.models.layers against repro.models.layers, fp32 on the CPU.

Inputs come from numpy with a fixed seed and go through both; tolerance
1e-5 (fp32, same formulas, different libraries' rounding)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = 1e-5


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 32).astype(np.float32) * 3
    scale = rng.randn(32).astype(np.float32)
    bias = rng.randn(32).astype(np.float32)
    jp = {"scale": jnp.asarray(scale)}
    tp = {"scale": torch.from_numpy(scale)}
    if kind == "layernorm":
        jp["bias"] = jnp.asarray(bias)
        tp["bias"] = torch.from_numpy(bias)
    jx, tx = _both(x)
    _close(tl.norm_apply(tp, tx, kind), jl.norm_apply(jp, jx, kind))


def test_head_norm():
    """qk-norm over head_dim with eps 1e-6: on head 0, whose rows have a
    mean square near 1e-6, eps 1e-5 would read about 0.3 of the value
    lower, so a wrong eps shows."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    x[:, :, 0] *= 1e-3
    scale = rng.randn(16).astype(np.float32)
    jx, tx = _both(x)
    _close(tl.head_norm_apply({"scale": torch.from_numpy(scale)}, tx),
           jl.head_norm_apply({"scale": jnp.asarray(scale)}, jx))


@pytest.mark.parametrize("pos_ndim", [1, 2])
def test_rope(pos_ndim):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 100
    if pos_ndim == 2:
        pos = np.stack([pos, pos + 5])
    jx, tx = _both(x)
    _close(tl.apply_rope(tx, torch.from_numpy(pos), 10_000.0),
           jl.apply_rope(jx, jnp.asarray(pos), 10_000.0))


def test_rope_rotates_split_halves():
    """Dimension i pairs with i + D/2, not with its neighbour."""
    d = 8
    x = torch.zeros(1, 1, 1, d)
    x[..., 0] = 1.0
    out = tl.apply_rope(x, torch.tensor([1]), 10_000.0)[0, 0, 0]
    assert abs(out[0] - np.cos(1.0)) < TOL
    assert abs(out[d // 2] - np.sin(1.0)) < TOL
    assert abs(out[1]) < TOL
    assert torch.count_nonzero(out.abs() > TOL) == 2


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    """SwiGLU for silu; for gelu, jax.nn.gelu's default tanh form."""
    rng = np.random.RandomState(2)
    d, f = 16, 40
    shapes = {"up": (d, f), "down": (f, d)}
    if act == "silu":
        shapes["gate"] = (d, f)
    w = {k: rng.randn(*s).astype(np.float32) * 0.3 for k, s in shapes.items()}
    jp = {k: {"w": jnp.asarray(v)} for k, v in w.items()}
    tp = {k: {"w": torch.from_numpy(v)} for k, v in w.items()}
    x = rng.randn(3, 4, d).astype(np.float32)
    jx, tx = _both(x)
    _close(tl.mlp_apply(tp, tx, act, torch.float32),
           jl.mlp_apply(jp, jx, act, jnp.float32))


def test_embed_and_unembed_padded_vocab():
    rng = np.random.RandomState(3)
    vocab_phys, vocab_logical, d = 32, 27, 16
    table = rng.randn(vocab_phys, d).astype(np.float32)
    ids = rng.randint(0, vocab_logical, size=(2, 6))
    jt, tt = _both(table)
    _close(tl.embed_apply({"table": tt}, torch.from_numpy(ids),
                          torch.float32),
           jl.embed_apply({"table": jt}, jnp.asarray(ids), jnp.float32))
    x = rng.randn(2, 6, d).astype(np.float32)
    jx, tx = _both(x)
    got = tl.unembed_apply(tt, tx, vocab_logical=vocab_logical)
    want = jl.unembed_apply(jt, jx, vocab_logical=vocab_logical)
    _close(got, want)
    assert torch.all(got[..., vocab_logical:] == -1e30)


def test_embed_gathers_rows_then_casts():
    """An fp32 table read in bf16 (the tied table of mamba2-130m): the
    port gathers the rows and casts them, the reference casts the table
    and gathers; the values are bit-for-bit the same."""
    rng = np.random.RandomState(4)
    table = rng.randn(50, 16).astype(np.float32)
    ids = rng.randint(0, 50, size=(3, 7))
    got = tl.embed_apply({"table": torch.from_numpy(table)},
                         torch.from_numpy(ids), torch.bfloat16)
    want = jl.embed_apply({"table": jnp.asarray(table)}, jnp.asarray(ids),
                          jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(table).to(torch.bfloat16)[
        torch.from_numpy(ids)])
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_sinusoidal_positions():
    """The table no config reads (``build`` refuses ``sinusoidal``), at
    an odd width, where the reference drops the last column."""
    for max_len, d in ((64, 32), (50, 33)):
        want = jl.sinusoidal_positions(max_len, d)
        got = tl.sinusoidal_positions(max_len, d)
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got, want)
