"""The port's W8A8 path (int8 activations with one scale per tensor, int8
weights, int32 accumulation) against the JAX package, on the CPU.

The JAX Pallas kernel runs in interpret mode and its oracle eagerly; the
port's CPU path is the kernel's plain version, ``qmatmul_w8a8_ref``.
Inputs come from numpy with a seed.

Tolerances.  Integer sums are exact, so with no activation the port equals
the eager JAX oracle bitwise, bias or not, and the interpret-mode kernel
bitwise without a bias.  The interpret-mode kernel runs under jit, where
XLA contracts the drain's ``* w_scale`` and ``+ bias`` into one fused
multiply-add: one rounding of the product fewer, at most half an ulp of
``acc * x_scale * w_scale``.  tanh, exp and the tanh-GELU are computed by
other libraries in the two frameworks and differ by a few ulps (measured
at most 4).  Where an output is not bitwise it must lie within
``2^-20 * max(|ref|, |acc * x_scale * w_scale|, 1)``: eight f32 ulps of
the larger of the output and the product, and of 1 for the activations'
tails near 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qlinear import W8A8 as JW8A8
from repro.core.qlinear import linear as jlinear
from repro.core.quant import quantize as jquantize
from repro.core.quant import quantize_weight as jquantize_weight
from repro.kernels import ops as JOPS
from repro.kernels import qmatmul as JK
from repro.kernels import ref as JREF
from repro_torch.core.qlinear import W8A8, linear
from repro_torch.core.quant import QTensor, quantize
from repro_torch.kernels import ops
from repro_torch.kernels import qmatmul as K

ACTS = ("none", "relu", "gelu", "silu", "tanh", "sigmoid")
# (M, K, N); the last two sit on the CUDA tensor-core kernel's tile edges:
# M one past a 32- or 128-row tile, K % 32 == 16 (a ragged last k step), N
# % 8 == 4 (a ragged n8 tile) and past a 128-column strip
SHAPES = [(8, 256, 128), (24, 512, 256), (1, 128, 384), (33, 544, 132),
          (129, 272, 260)]


def _blocks(m, k, n):
    """Interpret-mode blocks that divide the shape: one row block, 128 wide
    where 128 divides, else the whole of N and K in 16-row steps."""
    return dict(bm=m, bn=128 if n % 128 == 0 else n,
                bk=128 if k % 128 == 0 else 16)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xs = np.float32(rng.uniform(1e-3, 5e-2))
    ws = rng.uniform(1e-3, 5e-2, n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    return x, w, xs, ws, b


def _within(got, want, prod):
    tol = 2.0 ** -20 * np.maximum(np.maximum(np.abs(want), np.abs(prod)), 1.0)
    return bool((np.abs(got - want) <= tol).all())


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("activation", ACTS)
def test_w8a8_plain_matches_jax(m, k, n, with_bias, activation):
    x, w, xs, ws, b = _case(m + k + n, m, k, n)
    jb = jnp.asarray(b) if with_bias else None
    jargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(xs), jnp.asarray(ws),
             jb)
    interp = np.asarray(JK.qmatmul_w8a8(
        *jargs, activation=activation, out_dtype=jnp.float32,
        interpret=True, **_blocks(m, k, n)))
    oracle = np.asarray(JREF.qmatmul_w8a8_ref(
        *jargs, activation=activation, out_dtype=jnp.float32))
    got = K.qmatmul_w8a8_ref(
        torch.from_numpy(x), torch.from_numpy(w), torch.tensor(xs),
        torch.from_numpy(ws), torch.from_numpy(b) if with_bias else None,
        activation=activation, out_dtype=torch.float32).numpy()
    prod = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.float32) \
        * xs * ws
    if activation in ("none", "relu"):
        np.testing.assert_array_equal(got, oracle)
        if not with_bias:
            np.testing.assert_array_equal(got, interp)
    assert _within(got, oracle, prod)
    assert _within(got, interp, prod)


def test_w8a8_integer_accumulate_exact():
    """Unit scales, no bias, no activation: the f32 output is the exact
    integer sum (every |sum| < 2^24 here, so f32 holds it exactly), as the
    JAX kernel's own test asks of it."""
    rng = np.random.default_rng(7)
    x = rng.integers(-127, 128, (16, 1024)).astype(np.int8)
    w = rng.integers(-127, 128, (1024, 64)).astype(np.int8)
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() < 2 ** 24
    got = K.qmatmul_w8a8_ref(torch.from_numpy(x), torch.from_numpy(w),
                             torch.tensor(1.0), torch.ones(64))
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    interp = JK.qmatmul_w8a8(jnp.asarray(x), jnp.asarray(w),
                             jnp.ones((), jnp.float32),
                             jnp.ones((64,), jnp.float32), None, bm=16,
                             bn=64, bk=256, interpret=True,
                             out_dtype=jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(interp))


def _jax_weight(seed, k, n):
    rng = np.random.default_rng(seed)
    jw = jquantize_weight(jnp.asarray(
        rng.normal(size=(k, n)).astype(np.float32) * k ** -0.5))
    tw = QTensor(values=torch.from_numpy(np.array(jw.values)),
                 scale=torch.from_numpy(np.array(jw.scale)))
    return jw, tw


@pytest.mark.parametrize("out_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("activation", ["none", "gelu"])
def test_qmatmul_dynamic_matches_jitted_reference(out_dtype, activation):
    """ops.qmatmul_dynamic against the JAX one under jax.jit (as the serve
    CLI's prefill step runs it): the per-tensor activation quantization is
    bitwise, the output within the module's bound (f32) or one bf16 ulp."""
    rng = np.random.default_rng(3)
    k, n = 256, 128
    xf = rng.normal(size=(2, 8, k)).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32) * 0.1
    jw, tw = _jax_weight(4, k, n)
    jdt = jnp.bfloat16 if out_dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if out_dtype == "bf16" else torch.float32
    jx = jnp.asarray(xf).astype(jnp.bfloat16)
    tx = torch.from_numpy(xf).to(torch.bfloat16)

    jq = jax.jit(lambda x: jquantize(x.astype(jnp.float32), bits=8,
                                     axis=None))(jx)
    tq = quantize(tx.float(), bits=8, axis=None)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))

    want = np.asarray(jax.jit(lambda x, w, bb: JOPS.qmatmul_dynamic(
        x, w, bb, activation=activation, out_dtype=jdt))(
            jx, jw, jnp.asarray(b))).astype(np.float32)
    got = ops.qmatmul_dynamic(tx, tw, torch.from_numpy(b),
                              activation=activation,
                              out_dtype=tdt).float().numpy()
    assert got.shape == want.shape == (2, 8, n)
    if out_dtype == "bf16":
        assert (np.abs(got - want) <= 2.0 ** -8 * np.abs(want) + 1e-6).all()
    else:
        acc = (tq.values.numpy().reshape(-1, k).astype(np.int64)
               @ np.asarray(jw.values).astype(np.int64))
        prod = (acc.astype(np.float32) * tq.scale.numpy()
                * np.asarray(jw.scale)).reshape(want.shape)
        assert _within(got, want, prod)


def test_linear_w8a8_matches_jitted_reference():
    """core.qlinear.linear in W8A8 mode routes through qmatmul_dynamic, as
    the reference's does: bf16 activations in, bf16 out, within one bf16
    ulp of the jitted reference."""
    rng = np.random.default_rng(5)
    k, n = 128, 256
    xf = rng.normal(size=(3, 4, k)).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32) * 0.1
    jw, tw = _jax_weight(6, k, n)
    want = np.asarray(jax.jit(lambda x, w, bb: jlinear(
        {"w": w, "b": bb}, x, activation="gelu", mode=JW8A8))(
            jnp.asarray(xf).astype(jnp.bfloat16), jw,
            jnp.asarray(b))).astype(np.float32)
    got = linear({"w": tw, "b": torch.from_numpy(b)},
                 torch.from_numpy(xf).to(torch.bfloat16), activation="gelu",
                 mode=W8A8)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - want) <= 2.0 ** -8 * np.abs(want) + 1e-6).all()


def test_w8a8_rows_are_independent_of_the_batch():
    """A row's result is the same whether it is computed alone or among
    others: its integer sums are exact and its drain per element."""
    x, w, xs, ws, b = _case(11, 12, 256, 128)
    args = (torch.from_numpy(w), torch.tensor(xs), torch.from_numpy(ws),
            torch.from_numpy(b))
    full = K.qmatmul_w8a8_ref(torch.from_numpy(x), *args, activation="gelu")
    for i in range(12):
        one = K.qmatmul_w8a8_ref(torch.from_numpy(x[i:i + 1]), *args,
                                 activation="gelu")
        assert torch.equal(one[0], full[i])


def test_w8a8_kernel_wrapper_takes_only_cuda_tensors():
    x, w, xs, ws, _ = _case(1, 8, 128, 128)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.tensor(xs),
            torch.from_numpy(ws))
    calls = K.qmatmul_w8a8_ref.calls
    with pytest.raises(ValueError, match="CUDA"):
        K.qmatmul_w8a8(*args)
    for path in K.W8A8_PATHS:
        with pytest.raises(ValueError, match="CUDA"):
            K.qmatmul_w8a8_on_path(path, *args)
    with pytest.raises(ValueError, match="path"):
        K.qmatmul_w8a8_on_path("wmma", *args)
    assert K.qmatmul_w8a8_ref.calls == calls


@pytest.mark.parametrize("m", sorted({1, 8, 16, 17, K.W8A8_GEMV_MAX_ROWS,
                                      K.W8A8_GEMV_MAX_ROWS + 1, 512}))
def test_w8a8_path_is_chosen_by_rows_alone(m):
    """A decode tick's rows (8 or 16) go to the GEMV, a prefill's 512 to
    the tensor-core kernel, split at W8A8_GEMV_MAX_ROWS (64: the GEMV reads
    w once per 16 rows and was still the faster up to 64)."""
    assert K.W8A8_GEMV_MAX_ROWS == 64
    want = "gemv" if m <= K.W8A8_GEMV_MAX_ROWS else "mma"
    assert K.w8a8_path(m) == want
