"""The port's RMSNorm against the JAX package, on the CPU.

``layers.rmsnorm`` reduces each row on its own (``F.rms_norm``), so a
row's bits do not depend on how many rows share the call; the card's
``mean`` over the last dim does not promise that (its reduction layout
follows the row count).  Inputs come from numpy with a seed.

Tolerance.  Both packages compute x * rsqrt(mean(x^2) + eps) * scale in
f32 and cast back; they sum the squares in other orders and take rsqrt
from other libraries, a few f32 ulps apart (measured at most 2.5e-7
relative at d = 3072).  f32 out: 1e-6 relative.  bf16 out: those ulps can
move a value across a bf16 rounding boundary, one bf16 ulp (2^-7
relative) at most.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

DIMS = (3072, 48)      # starcoder2-3b's d_model, and a narrow one


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, rows, d, dtype):
    """x (rows, d) and scale (d,), as JAX and torch arrays of ``dtype``
    ("f32" or "bf16"); the bf16 x is rounded once, by JAX, and copied."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32) * 3.0
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16"
                               else jnp.float32)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)
    return jx, jnp.asarray(scale), tx, torch.from_numpy(scale)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", DIMS)
def test_rmsnorm_matches_jax(d, dtype):
    jx, jscale, tx, tscale = _case(d, 8, d, dtype)
    want = np.asarray(JL.rmsnorm({"scale": jscale}, jx).astype(jnp.float32))
    got = L.rmsnorm({"scale": tscale}, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    rel = 1e-6 if dtype == "f32" else 2.0 ** -7
    assert (np.abs(got.float().numpy() - want)
            <= rel * np.abs(want) + 1e-7).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", DIMS)
def test_rmsnorm_rows_are_batch_invariant(d, dtype):
    """Each row of a B = 8 call equals the same row normalised alone, and
    the rows of a (2, 4, d) call equal those of the flat (8, d) one."""
    _, _, tx, tscale = _case(d + 1, 8, d, dtype)
    p = {"scale": tscale}
    full = L.rmsnorm(p, tx)
    for i in range(8):
        assert torch.equal(L.rmsnorm(p, tx[i:i + 1])[0], full[i])
    assert torch.equal(L.rmsnorm(p, tx.reshape(2, 4, d)).reshape(8, d),
                       full)
