"""``qmatmul_w8a8``'s GEMV split plan (``kernels/qmatmul.py::
w8a8_split_plan``), on the CPU.

The GEMV (every W8A8 decode tick) cuts K into ranges, one per block of a
column strip, and adds their int32 partial sums in the same launch.  The
plan is computed by the wrapper and passed to the kernel; what the kernel
relies on is checked here, for every (K, N) of full-width starcoder2-3b
and one ragged shape: the plan depends on (K, N) alone, never on M; its
ranges are aligned to the kernel's 32-row k step, in order, and cover
[0, K) exactly once; a launch of up to 16 rows puts at least one block on
each of the card's 132 SMs.  Integer sums are exact, so the order in
which the last block adds the partials cannot change a bit: the last test
adds the plan's partials in a shuffled order and compares them with the
plain version and with the JAX reference on numpy inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro_torch.configs import get_config
from repro_torch.kernels import qmatmul as K

SMS = 132


def _projections():
    """(name, K, N) of each W8A8 projection of full-width starcoder2-3b."""
    c = get_config("starcoder2-3b")
    d, qd, kvd = c.d_model, c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return [("wq", d, qd), ("wk", d, kvd), ("wv", d, kvd), ("wo", qd, d),
            ("w_up", d, c.d_ff), ("w_down", c.d_ff, d),
            ("ragged", 3088, 260)]


SHAPES = _projections()


@pytest.mark.parametrize("name,k,n", SHAPES, ids=[s[0] for s in SHAPES])
def test_split_plan(name, k, n):
    plan = K.w8a8_split_plan(k, n)
    # a function of (K, N) only: every M gets the same plan; the scratch
    # (one int32 partial tile per split, one counter per 16-row slab and
    # strip) grows with M only
    for m in (1, 2, 8, 9, 16):
        got, work, counters = K.w8a8_launch(m, k, n)
        assert got == plan
        assert work == plan.splits * m * n
        assert counters == plan.strips
    assert K.w8a8_launch(17, k, n)[2] == 2 * plan.strips
    # ranges aligned to the 32-row k step, in order, covering [0, K) once
    ranges = plan.ranges
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    for b, e in ranges:
        assert b < e and b % K.W8A8_G == 0
        assert e % K.W8A8_G == 0 or e == k
    # a launch of up to 16 rows is one slab: it fills the card
    assert plan.strips == -(-n // K.W8A8_BN)
    assert plan.strips * plan.splits >= SMS
    assert plan.strips * plan.splits <= K.GEMV_TARGET_BLOCKS


@pytest.mark.parametrize("k,n", [(3080, 256), (3072, 258), (8, 64),
                                 (0, 64), (64, 0)])
def test_split_plan_refuses_shapes_the_kernel_cannot_take(k, n):
    with pytest.raises(ValueError):
        K.w8a8_split_plan(k, n)


def test_partials_in_any_order_equal_the_plain_and_jax_sums():
    """The ragged shape at 16 rows: the int32 partial sums of the plan's
    ranges, added in a shuffled order, equal the plain version's
    accumulate and the JAX reference's bit for bit (unit scales, no bias,
    no activation, f32 out; every |sum| < 2^24, so f32 holds it)."""
    k, n, m = 3088, 260, 16
    rng = np.random.default_rng(19)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    plan = K.w8a8_split_plan(k, n)
    parts = [x[:, b:e].astype(np.int32) @ w[b:e].astype(np.int32)
             for b, e in plan.ranges]
    acc = np.zeros((m, n), np.int32)
    for i in rng.permutation(len(parts)):
        acc += parts[i]
    assert np.abs(acc).max() < 2 ** 24
    plain = K.qmatmul_w8a8_ref(torch.from_numpy(x), torch.from_numpy(w),
                               torch.tensor(1.0), torch.ones(n)).numpy()
    jax_ref = np.asarray(JREF.qmatmul_w8a8_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.ones((), jnp.float32),
        jnp.ones((n,), jnp.float32), None, out_dtype=jnp.float32))
    np.testing.assert_array_equal(acc.astype(np.float32), plain)
    np.testing.assert_array_equal(acc.astype(np.float32), jax_ref)
