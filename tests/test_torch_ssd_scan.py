"""The port's SSD scan wrapper against the reference's, on the CPU.

On CPU tensors ``repro_torch.kernels.ssd_scan.ops.ssd_scan`` runs the
kernel's plain version (the chunked formula in fp32, a ragged S padded
with identity steps); ``repro.kernels.ssd_scan.ops.ssd_scan`` runs the
Pallas kernel in interpret mode.  The four ``SSD_CASES`` of
tests/test_kernels.py, with their tolerances (1e-4; 2e-4 for the
mamba2-130m-like tile, whose larger chunk sums more fp32 roundings),
inputs drawn with numpy.  The CUDA kernel itself is held to this plain
version on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ops as jops  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import counts  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402

#: (b, s, h, p, g, n, chunk, tol), as tests/test_kernels.py SSD_CASES
SSD_CASES = [
    (2, 128, 4, 32, 1, 64, 32, 1e-4),
    (1, 96, 4, 16, 2, 32, 32, 1e-4),
    (2, 100, 2, 16, 1, 16, 32, 1e-4),     # ragged -> pad path
    (1, 64, 8, 64, 1, 128, 64, 2e-4),     # mamba2-130m-like tile
]


def _inputs(b, s, h, p, g, n, seed=4):
    rng = np.random.RandomState(seed)
    xbar = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h)))
    dA_log = (-dt * np.exp(rng.uniform(size=(1, 1, h)))).astype(np.float32)
    Bm = rng.randn(b, s, g, n).astype(np.float32)
    Cm = rng.randn(b, s, g, n).astype(np.float32)
    return xbar, dA_log, Bm, Cm


@pytest.mark.parametrize("case", SSD_CASES,
                         ids=lambda c: "-".join(map(str, c[:7])))
def test_plain_scan_matches_reference_kernel(case):
    b, s, h, p, g, n, chunk, tol = case
    arrays = _inputs(b, s, h, p, g, n)
    yw, fw = jops.ssd_scan(*map(jnp.asarray, arrays), chunk=chunk)
    before = counts.get("ssd_scan")
    y, f = ops.ssd_scan(*map(torch.from_numpy, arrays), chunk=chunk)
    assert counts.get("ssd_scan") == before   # CPU tensors launch nothing
    assert y.shape == (b, s, h, p) and f.shape == (b, h, n, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), rtol=tol, atol=tol)
    np.testing.assert_allclose(f.numpy(), np.asarray(fw), rtol=tol, atol=tol)


def test_plain_scan_from_a_state_matches_recurrence():
    """``state0`` (``ssd_chunked``'s contract, beyond the Pallas kernel's):
    the chunked formula from a nonzero state against the reference's
    recurrence from the same state, 1e-4."""
    arrays = _inputs(2, 96, 4, 16, 2, 32, seed=5)
    s0 = np.random.RandomState(6).randn(2, 4, 32, 16).astype(np.float32)
    yw, fw = jssm.ssd_recurrent(*map(jnp.asarray, arrays),
                                state0=jnp.asarray(s0))
    y, f = ops.ssd_scan(*map(torch.from_numpy, arrays), chunk=32,
                        state0=torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(f.numpy(), np.asarray(fw), rtol=1e-4,
                               atol=1e-4)


def test_bf16_strided_b_and_c():
    """B/C as the model hands them over: bf16 column slices of one wider
    tensor.  The plain version widens them to fp32, which is exact, so it
    equals the call on contiguous fp32 copies."""
    b, s, h, p, g, n = 1, 64, 4, 16, 1, 32
    xbar, dA_log, _, _ = _inputs(b, s, h, p, g, n)
    xbc = torch.from_numpy(np.random.RandomState(7).randn(
        b, s, h * p + 2 * g * n).astype(np.float32)).to(torch.bfloat16)
    Bm = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
    Cm = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    assert not Bm.is_contiguous()
    x, da = torch.from_numpy(xbar), torch.from_numpy(dA_log)
    y, f = ops.ssd_scan(x, da, Bm, Cm, chunk=32)
    yc, fc = ops.ssd_scan(x, da, Bm.float().contiguous(),
                          Cm.float().contiguous(), chunk=32)
    assert torch.equal(y, yc) and torch.equal(f, fc)


def test_chunk_rule_follows_the_reference_wrapper():
    """A sequence shorter than the chunk runs as one chunk of its own
    length; a ragged longer one is padded to the chunk."""
    arrays = _inputs(1, 20, 2, 16, 1, 16)
    yw, fw = jops.ssd_scan(*map(jnp.asarray, arrays), chunk=256)
    y, f = ops.ssd_scan(*map(torch.from_numpy, arrays), chunk=256)
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(f.numpy(), np.asarray(fw), rtol=1e-4,
                               atol=1e-4)
