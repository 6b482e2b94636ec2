"""The paper's six apps (``models/paper_nets.py``) against the JAX package,
on the CPU at small size, and the int8 matmuls at any K and N.

The same weights go into both packages: the reference's ``init_app`` and
``quantize_tree`` output, copied through numpy by ``models/bridge.py``
(which stores every 2-D weight padded for the kernels, as the port's
quantizer does).  The configs' widths break the kernels' alignment on
purpose (K % 16 != 0, N % 4 != 0), so the padded weights are what the
port runs.  The JAX side runs its plain reference (``ops.py`` takes it on
the CPU).

Tolerances, against the reference on the same inputs: FP and W8A16 within
``REL_MAX`` of the output's largest magnitude (both packages add f32
products of the same bf16- or int8-rounded operands, in other orders);
W8A8 within ``REL_L2`` in relative L2 norm, with the first layer's int8
activations and their scale bitwise equal (the quantizer is bitwise the
reference's; a later layer's input may round one int8 step apart where
the f32 sums that feed it differ in their last bits).  The worst errors
measured: FP 1.5e-07 (the LSTM), W8A16 3.1e-07 (the LSTM), relative to
the largest magnitude; W8A8 2.4e-07 in relative L2 (the LSTM; the MLP's
output is bitwise the reference's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_apps import PAPER_APP_CONFIGS as JCONFIGS
from repro.core import qlinear as JQL
from repro.core.quant import QTensor as JQTensor
from repro.core.quant import quantize as jquantize
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import paper_nets as JPN
from repro_torch.configs.paper_apps import PAPER_APP_CONFIGS, PaperAppConfig
from repro_torch.core import qlinear as QL
from repro_torch.core.quant import (KERNEL_K_ALIGN, KERNEL_N_ALIGN, QTensor,
                                    pad_weight, quantize, quantize_tree,
                                    quantize_weight)
from repro_torch.kernels import ops
from repro_torch.kernels import qmatmul as K
from repro_torch.models import bridge
from repro_torch.models import paper_nets as PN
from repro_torch.models import transformer as TF

REL_MAX = 1e-4
REL_L2 = 1e-3
MIN_SIZE = 256          # below the smallest FC (36 x 20): every FC quantizes

# widths that the int8 kernels do not take as they are
SMALL = {
    "mlp": PaperAppConfig("mlp", "mlp", batch=4, deadline_ms=7.0,
                          widths=(36, 38, 36)),
    "lstm": PaperAppConfig("lstm", "lstm", batch=4, deadline_ms=7.0,
                           n_cells=2, hidden=10),
    "cnn": PaperAppConfig("cnn", "cnn", batch=4, deadline_ms=7.0,
                          conv_channels=(12, 12), spatial=5,
                          fc_tail=(44, 36, 20)),
}
MODES = {"FP": (JQL.FP, QL.FP), "W8A16": (JQL.W8A16, QL.W8A16),
         "W8A8": (JQL.W8A8, QL.W8A8)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda x: ((np.asarray(x.values), np.asarray(x.scale))
                   if isinstance(x, JQTensor) else np.asarray(x)),
        tree, is_leaf=lambda x: isinstance(x, JQTensor))


def _inputs(cfg, batch=3, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.kind == "mlp":
        shape = (batch, cfg.widths[0])
    elif cfg.kind == "lstm":
        shape = (batch, 8, cfg.hidden)
    else:
        shape = (batch, cfg.spatial, cfg.spatial, cfg.conv_channels[0])
    return rng.standard_normal(shape).astype(np.float32)


def _both(cfg, quantized):
    jp = JPN.init_app(jax.random.PRNGKey(1), cfg)
    if quantized:
        jp = jquantize_tree(jp, min_size=MIN_SIZE)
    return jp, bridge.params_from_numpy(to_numpy(jp), device="cpu")


def _fcs(params):
    """The FC weights of an app's tree."""
    for name in ("layers", "cells", "fcs"):
        for lp in params.get(name, []):
            yield lp["w"]["w"] if name == "cells" else lp["w"]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", list(SMALL))
def test_app_matches_reference(kind, mode):
    cfg = SMALL[kind]
    jmode, tmode = MODES[mode]
    jp, tp = _both(cfg, mode != "FP")
    if mode != "FP":
        fcs = list(_fcs(tp))
        assert fcs and all(isinstance(w, QTensor) for w in fcs)
        # the widths break the kernels' alignment: the port runs padded
        # weights at the reference's logical shapes
        assert any(w.logical is not None for w in fcs)
        for w in fcs:
            assert w.values.shape[0] % KERNEL_K_ALIGN == 0
            assert w.values.shape[1] % KERNEL_N_ALIGN == 0
    x = _inputs(cfg)
    want = np.asarray(JPN.apply_app(jp, cfg, jnp.asarray(x), mode=jmode))
    got = PN.apply_app(tp, cfg, torch.from_numpy(x), mode=tmode).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.isfinite(got).all()
    if mode == "W8A8":
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= REL_L2, rel
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= REL_MAX, rel


@pytest.mark.parametrize("kind", ["mlp", "lstm"])
def test_w8a8_first_layer_int8_activations_bitwise(kind):
    """The W8A8 path's first quantized input (the whole tensor, one
    scale) is bitwise the reference's."""
    cfg = SMALL[kind]
    x = _inputs(cfg)
    if kind == "lstm":              # the first cell's [x_0; h = 0]
        x = np.concatenate([x[:, 0], np.zeros_like(x[:, 0])], axis=-1)
    want = jquantize(jnp.asarray(x), bits=8, axis=None)
    got = quantize(torch.from_numpy(x), bits=8, axis=None)
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_bridge_keeps_lists_and_pads_each_weight():
    cfg = SMALL["cnn"]
    jp, tp = _both(cfg, True)
    assert isinstance(tp["convs"], list) and isinstance(tp["fcs"], list)
    assert len(tp["convs"]) == 2 and len(tp["fcs"]) == 3
    for jl, tl in zip(jp["fcs"], tp["fcs"]):
        jw, tw = jl["w"], tl["w"]
        assert tuple(tw.shape) == tuple(jw.shape)
        k, n = jw.shape
        np.testing.assert_array_equal(tw.values[:k, :n].numpy(),
                                      np.asarray(jw.values))
        assert not tw.values[k:].any() and not tw.values[:, n:].any()
        np.testing.assert_array_equal(tw.scale[:, :n].numpy(),
                                      np.asarray(jw.scale))
        assert (tw.scale[:, n:] == 1.0).all()
        np.testing.assert_array_equal(tl["b"].numpy(), np.asarray(jl["b"]))
    # a conv weight (4-D, per (h, w, out) scales) is not padded
    cw = tp["convs"][0]["w"]
    assert cw.logical is None and tuple(cw.scale.shape) == (3, 3, 1, 12)
    assert PN.weight_count(tp) == JPN.weight_count(jp)


def test_port_quantizer_pads_as_the_bridge():
    """The port's quantize_tree of the same f32 weights gives the bridged
    quantized tree, bitwise, padding included."""
    cfg = SMALL["mlp"]
    jfp, tfp = _both(cfg, False)
    _, tq = _both(cfg, True)
    mine = quantize_tree(tfp, min_size=MIN_SIZE)
    for a, b in zip(_fcs(mine), _fcs(tq)):
        assert a.logical == b.logical
        assert torch.equal(a.values, b.values)
        assert torch.equal(a.scale, b.scale)


def test_weight_counts_match_table1():
    """Table 1's weight counts within 20% for the six configs, counted on
    the meta device (the same shapes as a full init, no memory)."""
    for name, cfg in PAPER_APP_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JCONFIGS[name])
        params = PN.init_app(None, cfg, device="meta")
        w = PN.weight_count(params)
        assert w == pytest.approx(cfg.weights_target_m * 1e6, rel=0.20), name


@pytest.mark.parametrize("name", ["MLP1", "LSTM0", "CNN1"])
def test_padded_weights_keep_table1_shapes(name):
    """The quantized apps whose widths the kernels do not take as they are
    keep their logical shapes: weight_count is the FP tree's."""
    cfg = PAPER_APP_CONFIGS[name]
    if cfg.kind == "cnn":           # the FC tail alone (the convs are big)
        cfg = dataclasses.replace(cfg, conv_channels=(8,), spatial=4)
    gen = torch.Generator().manual_seed(0)
    params = PN.init_app(gen, cfg, device="cpu")
    q = quantize_tree(params, min_size=1024)
    assert PN.weight_count(q) == PN.weight_count(params)
    padded = [w for w in _fcs(q) if w.logical is not None]
    assert padded
    for w in padded:
        assert tuple(w.shape) == w.logical
        assert w.values.shape[0] % 16 == 0 and w.values.shape[1] % 4 == 0


@pytest.mark.parametrize("name", ["MLP1", "LSTM1", "CNN0"])
def test_quantized_close(name):
    """The int8 apps (W8A16, W8A8) stay within 10% (relative L2) of the
    FP forward, at reduced depth where full depth is slow on the CPU."""
    cfg = PAPER_APP_CONFIGS[name]
    cfg = dataclasses.replace(cfg, n_cells=min(cfg.n_cells, 3),
                              conv_channels=cfg.conv_channels[:4])
    gen = torch.Generator().manual_seed(0)
    params = PN.init_app(gen, cfg, device="cpu")
    x = PN.app_input(cfg, batch=4, device="cpu")
    y = PN.apply_app(params, cfg, x)
    qp = quantize_tree(params, min_size=1024)
    for mode in (QL.W8A16, QL.W8A8):
        yq = PN.apply_app(qp, cfg, x, mode=mode)
        rel = float(torch.linalg.norm(yq - y) / (torch.linalg.norm(y) + 1e-9))
        assert rel < 0.1, (mode, rel)


def test_lstm_gate_order_and_forget_bias():
    """One cell by hand: z splits as (i, f, g, o) and the forget gate
    carries +1.0, as the reference's ``_lstm_cell``."""
    d = 3
    gen = torch.Generator().manual_seed(0)
    cp = {"w": TF._linear(gen, 2 * d, 4 * d, bias=True,
                          dtype=torch.float32, device="cpu")}
    cp["w"]["b"] = torch.randn(4 * d, generator=gen)
    x, h, c = (torch.randn(2, d, generator=gen) for _ in range(3))
    z = QL.linear(cp["w"], torch.cat([x, h], -1))
    i, f, g, o = z[:, :d], z[:, d:2 * d], z[:, 2 * d:3 * d], z[:, 3 * d:]
    c_want = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_want = torch.sigmoid(o) * torch.tanh(c_want)
    h_got, c_got = PN._lstm_cell(cp, x, h, c, QL.FP)
    assert torch.equal(c_got, c_want) and torch.equal(h_got, h_want)
    # and the JAX cell on the same numbers
    jcp = {"w": {"w": jnp.asarray(cp["w"]["w"].numpy()),
                 "b": jnp.asarray(cp["w"]["b"].numpy())}}
    jh, jc = JPN._lstm_cell(jcp, *(jnp.asarray(t.numpy()) for t in (x, h, c)),
                            JQL.FP)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-6)


def test_cnn_tail_tiles_then_slices():
    """The pooled features are tiled to the first FC's logical K and cut
    there (5 channels -> 12: [f0..f4, f0..f4, f0, f1])."""
    cfg = PaperAppConfig("t", "cnn", batch=1, deadline_ms=1.0,
                         conv_channels=(5,), spatial=2, fc_tail=(12,))
    gen = torch.Generator().manual_seed(0)
    params = PN.init_app(gen, cfg, device="cpu")
    eye = torch.eye(12)
    params["fcs"][0] = {"w": eye, "b": torch.zeros(12)}
    x = torch.randn(1, 2, 2, 5, generator=gen)
    pooled = torch.clamp_min(PN._conv2d(params["convs"][0]["w"], x)
                             + params["convs"][0]["b"], 0.0).mean((1, 2))
    got = PN.cnn_app(params, x)
    want = torch.cat([pooled, pooled, pooled[:, :2]], -1)
    # the FP linear rounds its operands to bf16
    torch.testing.assert_close(got, want.to(torch.bfloat16).float(),
                               rtol=0, atol=0)
    # the same through a padded int8 weight (K 12 -> 16)
    qp = dict(params, fcs=[{"w": quantize_weight(eye), "b": torch.zeros(12)}])
    assert qp["fcs"][0]["w"].values.shape == (16, 12)
    got_q = PN.cnn_app(qp, x, mode=QL.W8A16)
    torch.testing.assert_close(got_q, pooled.repeat(1, 3)[:, :12],
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the int8 matmuls at any K and N
# ---------------------------------------------------------------------------

KS = (1118, 2084, 3700, 7400)
NS = (1118, 3700)


def _weight(k, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return quantize_weight(torch.randn(k, n, generator=gen) * k ** -0.5)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", KS)
def test_padded_call_equals_unpadded_plain(k, n):
    """Through the plain versions, the padded weight's call (x zero-padded
    to the stored K, the first N columns kept) equals the unpadded plain
    call within f32 rounding, W8A16 and W8A8, at M = 3.  The padding's
    zero rows and columns add exact zeros, so only the order of the f32
    sums differs."""
    w = _weight(k, n, k + n)
    assert w.logical == (k, n) and tuple(w.shape) == (k, n)
    kp, np_ = w.values.shape
    assert kp == k + (-k) % 16 and np_ == n + (-n) % 4
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, k, generator=gen)
    b = torch.randn(n, generator=gen)
    u = w.unpadded()
    # the call the card makes, on the padded operands
    xp = torch.nn.functional.pad(x, (0, kp - k))
    bp = ops._padded_bias(b, np_)
    padded = K.qmatmul_w8a16_ref(xp, w.values, w.scale, bp,
                                 activation="relu",
                                 out_dtype=torch.float32)[:, :n]
    plain = K.qmatmul_w8a16_ref(x, u.values, u.scale, b, activation="relu",
                                out_dtype=torch.float32)
    torch.testing.assert_close(padded, plain, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        ops.qmatmul(x, w, b, activation="relu", out_dtype=torch.float32),
        plain, rtol=0, atol=0)
    xq = quantize(x, bits=8, axis=None)
    xqp = quantize(xp, bits=8, axis=None)
    assert torch.equal(xqp.scale, xq.scale)       # zeros move no amax
    padded8 = K.qmatmul_w8a8_ref(xqp.values, w.values, xqp.scale, w.scale,
                                 bp, out_dtype=torch.float32)[:, :n]
    plain8 = K.qmatmul_w8a8_ref(xq.values, u.values, xq.scale, u.scale, b,
                                out_dtype=torch.float32)
    assert torch.equal(padded8, plain8)           # exact integer sums
    torch.testing.assert_close(
        ops.qmatmul_dynamic(x, w, b, out_dtype=torch.float32), plain8,
        rtol=0, atol=0)


def test_pad_weight_is_once_and_leaves_aligned_weights():
    w = _weight(64, 32, 0)
    assert w.logical is None and w.values.shape == (64, 32)
    p = _weight(20, 6, 0)
    assert pad_weight(p) is p                       # already padded
    stack = quantize(torch.randn(2, 20, 6), bits=8, axis=(1,))
    assert pad_weight(stack) is stack               # a stack is left as is
    table = quantize(torch.randn(37, 18), bits=8, axis=(1,))
    assert pad_weight(table) is table               # per-row scales too
    torch.testing.assert_close(p.dequantize(),
                               p.values[:20, :6].float() * p.scale[:, :6])
    assert p.nbytes_weights == 20 * 6 + 6 * 4


def test_bias_is_padded_once():
    b = torch.randn(6)
    first = ops._padded_bias(b, 8)
    assert first.shape == (8,) and not first[6:].any()
    assert ops._padded_bias(b, 8) is first
    assert ops._padded_bias(None, 8) is None
    assert ops._padded_bias(first, 8) is first
