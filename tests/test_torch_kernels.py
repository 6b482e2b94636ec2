"""The port's kernel modules against the JAX package, on the CPU.

The CUDA kernels cannot run here (no card, no nvcc), so these tests hold
their plain PyTorch versions — which the CPU path of the port runs — to
the JAX reference on the same numpy inputs: the Pallas kernels in
interpret mode and the ``kernels/ref.py`` oracles.  They also pin the two
properties the serving engine's bit parity needs: quantization bitwise
equal to the reference, and every row's result independent of the batch.
The kernels themselves are compared with their plain versions on the card
by ``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import quant as tquant
from repro_torch.core.quant import QTensor
from repro_torch.kernels import decode_attention as A
from repro_torch.kernels import ops
from repro_torch.kernels import qmatmul as K
from repro_torch.models import layers as TL

ACTS = ("none", "relu", "gelu", "silu", "tanh", "sigmoid")


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops; one intra-op thread keeps them fast beside the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> float:
    """Largest |a - b| in units of one bf16 ulp of b (2^-7 relative).  The
    unit is floored at that of 1e-4: outputs here are O(1), so sums that
    cancel to near zero carry f32 rounding of ~1e-7 absolute, which relu,
    say, may keep on one side and zero on the other."""
    scale = np.maximum(np.abs(b), 1e-4) * 2.0 ** -7
    return float(np.max(np.abs(a - b) / scale))


def _qweight(rng, k, n):
    w = jquant.quantize_weight(jnp.asarray(
        rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5))
    return np.array(w.values), np.array(w.scale).reshape(-1)


# ---------------------------------------------------------------------------
# qmatmul_w8a16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("has_bias", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_qmatmul_plain_matches_jax(act, has_bias, m, x_dtype):
    """Plain qmatmul, through ``ops.qmatmul`` and a QTensor, vs the JAX
    package's ``ops.qmatmul(..., interpret=True)`` (the Pallas kernel under
    the interpreter) and ``ref.qmatmul_w8a16_ref``, for every activation,
    bias or none, M in {1, 3, 8}, bf16 and f32 activations.  Tolerance:
    all three accumulate the same f32 products in other orders (~1e-7
    relative); rounded to a bf16 output that is at most one bf16 ulp."""
    rng = np.random.default_rng(
        [ACTS.index(act), has_bias, m, x_dtype == "bf16"])
    k, n = 128, 72
    wq = jquant.quantize_weight(jnp.asarray(
        rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5))
    x = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal(n).astype(np.float32) * 0.1
         if has_bias else None)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if x_dtype == "bf16"
                               else jnp.float32)
    jb = None if b is None else jnp.asarray(b)
    kernel = jops.qmatmul(jx, wq, jb, activation=act,
                          out_dtype=jnp.bfloat16, interpret=True)
    oracle = jref.qmatmul_w8a16_ref(jx, wq.values, wq.scale.reshape(-1), jb,
                                    activation=act, out_dtype=jnp.bfloat16)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16 if x_dtype == "bf16" else torch.float32)
    tq = QTensor(torch.tensor(np.asarray(wq.values)),
                 torch.tensor(np.asarray(wq.scale)))
    got = ops.qmatmul(tx, tq, None if b is None else torch.tensor(b),
                      activation=act)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    for want in (kernel, oracle):
        assert _bf16_ulps(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32))) <= 1.0


def test_qmatmul_plain_takes_nd_input():
    """Leading dims flatten to M and come back, as in the reference."""
    rng = np.random.default_rng(7)
    wv, ws = _qweight(rng, 64, 24)
    x = torch.tensor(rng.standard_normal((2, 3, 64)).astype(np.float32))
    tq = QTensor(torch.tensor(wv), torch.tensor(ws))
    got = ops.qmatmul(x, tq, activation="silu")
    want = ops.qmatmul(x.reshape(6, 64), tq, activation="silu")
    assert got.shape == (2, 3, 24)
    assert torch.equal(got.reshape(6, 24), want)


def test_qmatmul_plain_f32_out_matches_jax_oracle():
    """f32 output (the LM head's): f32-rounding agreement, 1e-5 relative."""
    rng = np.random.default_rng(3)
    wv, ws = _qweight(rng, 64, 48)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    want = np.asarray(jref.qmatmul_w8a16_ref(
        jnp.asarray(x), jnp.asarray(wv), jnp.asarray(ws),
        out_dtype=jnp.float32))
    got = K.qmatmul_w8a16_ref(torch.from_numpy(x), torch.from_numpy(wv),
                              torch.from_numpy(ws),
                              out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_qmatmul_plain_rows_are_batch_invariant(x_dtype):
    """Row i of an M=8 product is bit-identical to the same row alone."""
    rng = np.random.default_rng(11)
    wv, ws = _qweight(rng, 256, 96)
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(
        np.float32)).to(x_dtype)
    w, s = torch.from_numpy(wv), torch.from_numpy(ws)
    full = K.qmatmul_w8a16_ref(x, w, s, activation="gelu")
    for i in range(8):
        one = K.qmatmul_w8a16_ref(x[i:i + 1], w, s, activation="gelu")
        assert torch.equal(one[0], full[i])


def test_qmatmul_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches or raises; it never computes on the
    CPU itself (that is the plain version's job, chosen by ops.py)."""
    w = torch.zeros((8, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        K.qmatmul_w8a16(torch.zeros((1, 8)), w, torch.ones(8))
    assert K.qmatmul_w8a16.launches == 0


# ---------------------------------------------------------------------------
# decode_attention_int8
# ---------------------------------------------------------------------------

def _attn_inputs(rng, b, s, kvh, g, hd):
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    k = rng.integers(-127, 128, (b, s, kvh, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (b, s, kvh, hd)).astype(np.int8)
    ks = (rng.random((b, s, kvh, 1)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((b, s, kvh, 1)) * 0.02 + 1e-3).astype(np.float32)
    return q, k, v, ks, vs


@pytest.mark.parametrize("append", [False, True])
@pytest.mark.parametrize("g", [1, 2, 12])
def test_decode_attention_plain_matches_jax_kernel_interpret(g, append):
    """Plain decode attention (through ``ops.decode_attention``) vs the
    Pallas kernel under the interpreter, per-row valid_len including 0,
    with and without the append column.  Both are f32 softmax attention
    over the same dequantized terms, summed in another order (the kernel
    online, tile by tile): 1e-5 relative + 1e-6 absolute."""
    rng = np.random.default_rng(100 * g + append)
    b, s, kvh, hd = 4, 40, 2, 32
    q, k, v, ks, vs = _attn_inputs(rng, b, s, kvh, g, hd)
    vl = np.array([0, 1, 17, 40], np.int32)
    kn = vn = None
    if append:
        kn = rng.standard_normal((b, 1, kvh, hd)).astype(np.float32)
        vn = rng.standard_normal((b, 1, kvh, hd)).astype(np.float32)
    want = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(vl),
        k_new=None if kn is None else jnp.asarray(kn),
        v_new=None if vn is None else jnp.asarray(vn), interpret=True))
    t = torch.from_numpy
    got = ops.decode_attention(
        t(q), t(k), t(v), t(ks), t(vs), t(vl),
        k_new=None if kn is None else t(kn),
        v_new=None if vn is None else t(vn)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if not append:
        assert np.all(got[0] == 0.0)          # valid_len 0: no key, zeros
    else:
        np.testing.assert_array_equal(        # empty cache: exactly v_new
            got[0], np.broadcast_to(vn[0, 0][:, None, :], (kvh, g, hd)))


def test_decode_attention_plain_matches_jax_oracle_bf16_query():
    """bf16 queries (the decode path's), scalar valid_len broadcast to
    every row: same tolerance as above."""
    rng = np.random.default_rng(5)
    q, k, v, ks, vs = _attn_inputs(rng, 3, 24, 2, 12, 32)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    want = np.asarray(jref.decode_attention_int8_ref(
        jq, jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(9, jnp.int32)))
    tq = torch.tensor(np.asarray(jq.astype(jnp.float32))).to(
        torch.bfloat16)
    t = torch.from_numpy
    got = ops.decode_attention(tq, t(k), t(v), t(ks), t(vs), 9).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_decode_attention_plain_rows_are_batch_invariant():
    rng = np.random.default_rng(9)
    q, k, v, ks, vs = _attn_inputs(rng, 8, 32, 2, 12, 32)
    t = torch.from_numpy
    vl = torch.tensor([0, 3, 32, 7, 19, 1, 25, 12], dtype=torch.int32)
    full = A.decode_attention_int8_ref(t(q), t(k), t(v), t(ks), t(vs), vl)
    for i in range(8):
        sl = slice(i, i + 1)
        one = A.decode_attention_int8_ref(t(q[sl]), t(k[sl]), t(v[sl]),
                                          t(ks[sl]), t(vs[sl]), vl[sl])
        assert torch.equal(one[0], full[i])


def test_decode_attention_cuda_wrapper_refuses_cpu_tensors():
    z8 = torch.zeros((1, 4, 1, 16), dtype=torch.int8)
    zs = torch.ones((1, 4, 1))
    with pytest.raises(ValueError, match="CUDA"):
        A.decode_attention_int8(torch.zeros((1, 1, 2, 16)), z8, z8, zs, zs,
                                torch.ones(1, dtype=torch.int32))
    assert A.decode_attention_int8.launches == 0


# ---------------------------------------------------------------------------
# quantization: bitwise equal to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(96, 40), (3, 64, 48)])
def test_quantize_weight_bitwise(shape):
    rng = np.random.default_rng(len(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0                               # a dead column: 1e-8 floor
    want = jquant.quantize_weight(jnp.asarray(w))
    got = tquant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_quantize_embedding_bitwise():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((50, 32)).astype(np.float32) * 0.3
    w[7] = 0.0
    want = jquant.quantize_embedding(jnp.asarray(w))
    got = tquant.quantize_embedding(torch.from_numpy(w))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@jax.jit
def _jax_q8(t):
    """The reference's per-token k/v quantization, ``layers.py:298-304``
    (a closure inside ``attention`` there, so restated here verbatim, and
    jitted as the reference's decode step is: under jit XLA turns the
    division by 127.0 into a multiply by its reciprocal)."""
    tf = t.astype(jnp.float32)
    amax = jnp.maximum(jnp.max(jnp.abs(tf), axis=-1, keepdims=True), 1e-6)
    sc = amax / 127.0
    return jnp.round(tf / sc).astype(jnp.int8), sc.astype(jnp.float32)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_kv_q8_bitwise(dtype):
    rng = np.random.default_rng(4)
    t = rng.standard_normal((4, 1, 2, 32)).astype(np.float32)
    t[1, 0, 1] = 0.0                              # all-zero head: 1e-6 floor
    jt = jnp.asarray(t).astype(jnp.bfloat16 if dtype == "bf16"
                               else jnp.float32)
    want_v, want_s = _jax_q8(jt)
    tt = torch.tensor(np.asarray(jt.astype(jnp.float32)))
    if dtype == "bf16":
        tt = tt.to(torch.bfloat16)
    got_v, got_s = TL.q8(tt)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
