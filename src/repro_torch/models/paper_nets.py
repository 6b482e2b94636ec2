"""The paper's six production NNs (Table 1) as runnable PyTorch models.

The port of ``repro/models/paper_nets.py``, with its names, layouts and
f32 default.  Weight counts match Table 1 (the roofline-relevant
quantity; exact internal topologies are not public).  Every FC routes
through the quantized ``core/qlinear.py::linear``, so under W8A16 or W8A8
each runs the hand-written ``qmatmul_w8a16`` or ``qmatmul_w8a8`` kernel on
the card, at the paper's widths (stored padded where K or N is not a
shape the kernels take: ``core/quant.py::pad_weight``).

- MLP0/MLP1: stacks of FC+ReLU layers (RankBrain-like).
- LSTM0/LSTM1: stacked LSTM cells, a Python loop over T = 8 (the
  reference's ``lax.scan``).
- CNN0: AlphaGo-style 19x19 board net (16 conv layers of 256 3x3 filters).
- CNN1: Inception-like conv stack + 4 FC tail layers.

Activations are NHWC and conv weights HWIO, as in the reference, so a
quantized conv weight's scales (3, 3, 1, C_out) mean the same in both
packages.  Init draws from an explicit ``torch.Generator`` on an explicit
device: the same distributions as the reference's, other numbers (tests
carry the reference's params over through ``models/bridge.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_apps import PaperAppConfig
from repro_torch.core.qlinear import FP, QuantMode, linear
from repro_torch.core.quant import QTensor
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp_app(gen, cfg: PaperAppConfig, dtype=torch.float32,
                 device=None) -> dict:
    layers = []
    d_prev = cfg.widths[0]
    for w in cfg.widths:
        layers.append(TF._linear(gen, d_prev, w, bias=True, dtype=dtype,
                                 device=device))
        d_prev = w
    return {"layers": layers}


def mlp_app(params: dict, x: Tensor, *, mode: QuantMode = FP) -> Tensor:
    for i, lp in enumerate(params["layers"]):
        last = i == len(params["layers"]) - 1
        x = linear(lp, x, activation="none" if last else "relu", mode=mode)
    return x


# ---------------------------------------------------------------------------
# LSTMs
# ---------------------------------------------------------------------------

def init_lstm_app(gen, cfg: PaperAppConfig, dtype=torch.float32,
                  device=None) -> dict:
    """n_cells stacked LSTM cells of width ``hidden``; 4 gate matmuls per
    cell on [x; h] (the paper's '24 FC layers' for LSTM0 = 6 cells x 4
    gates), as one (2 hidden, 4 hidden) weight."""
    return {"cells": [{"w": TF._linear(gen, 2 * cfg.hidden, 4 * cfg.hidden,
                                       bias=True, dtype=dtype,
                                       device=device)}
                      for _ in range(cfg.n_cells)]}


def _lstm_cell(cp: dict, x: Tensor, h: Tensor, c: Tensor, mode: QuantMode):
    z = linear(cp["w"], torch.cat([x, h], dim=-1), mode=mode)
    i, f, g, o = torch.split(z, z.shape[-1] // 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_app(params: dict, x_seq: Tensor, *, mode: QuantMode = FP) -> Tensor:
    """x_seq: (B, T, hidden) -> the last cell's final hidden state
    (B, hidden)."""
    b, t, d = x_seq.shape
    n = len(params["cells"])
    h = [x_seq.new_zeros((b, d)) for _ in range(n)]
    c = [x_seq.new_zeros((b, d)) for _ in range(n)]
    for step in range(t):
        inp = x_seq[:, step]
        for i, cp in enumerate(params["cells"]):
            h[i], c[i] = _lstm_cell(cp, inp, h[i], c[i], mode)
            inp = h[i]
    return h[-1]


# ---------------------------------------------------------------------------
# CNNs
# ---------------------------------------------------------------------------

def init_cnn_app(gen, cfg: PaperAppConfig, dtype=torch.float32,
                 device=None) -> dict:
    convs = []
    c_prev = cfg.conv_channels[0]
    for c in cfg.conv_channels:
        # He init: preserves activation scale through deep ReLU conv stacks
        w = torch.empty((3, 3, c_prev, c), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                    generator=gen)
        convs.append({"w": (w * (2.0 / (9 * c_prev)) ** 0.5).to(dtype),
                      "b": torch.zeros((c,), dtype=dtype, device=device)})
        c_prev = c
    fcs = []
    d_prev = None
    for w in cfg.fc_tail:
        d_prev = d_prev or cfg.fc_tail[0]
        fcs.append(TF._linear(gen, d_prev, w, bias=True, dtype=dtype,
                              device=device))
        d_prev = w
    return {"convs": convs, "fcs": fcs}


def _conv2d(w, x: Tensor) -> Tensor:
    """SAME 3x3 conv of NHWC ``x`` by HWIO ``w`` (an int8 QTensor is
    dequantized first: weight-only quant), in f32 products: TF32 is off
    for this call, whatever the global setting."""
    if isinstance(w, QTensor):
        w = w.dequantize(torch.float32).to(x.dtype)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(x.permute(0, 3, 1, 2),
                     w.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def cnn_app(params: dict, x: Tensor, *, mode: QuantMode = FP) -> Tensor:
    """x: (B, H, W, C)."""
    for cp in params["convs"]:
        x = torch.clamp_min(_conv2d(cp["w"], x) + cp["b"], 0.0)
    if params["fcs"]:
        x = x.mean(dim=(1, 2))
        # project pooled features to the first FC width (the logical K of
        # a padded weight)
        d_in = params["fcs"][0]["w"].shape[-2]
        reps = -(-d_in // x.shape[-1])
        x = x.repeat(1, reps)[:, :d_in]
        for i, lp in enumerate(params["fcs"]):
            last = i == len(params["fcs"]) - 1
            x = linear(lp, x, activation="none" if last else "relu",
                       mode=mode)
    return x


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def init_app(gen, cfg: PaperAppConfig, dtype=torch.float32,
             device=None) -> dict:
    """Random params of ``cfg`` from ``gen`` (its device must be
    ``device``'s type; None is the card)."""
    device = resolve_device(device)
    return {"mlp": init_mlp_app, "lstm": init_lstm_app,
            "cnn": init_cnn_app}[cfg.kind](gen, cfg, dtype, device)


def apply_app(params: dict, cfg: PaperAppConfig, x: Tensor, *,
              mode: QuantMode = FP) -> Tensor:
    return {"mlp": mlp_app, "lstm": lstm_app,
            "cnn": cnn_app}[cfg.kind](params, x, mode=mode)


def app_input(cfg: PaperAppConfig, batch: int, gen=None,
              dtype=torch.float32, device=None) -> Tensor:
    """A standard-normal input batch: (B, width) for an MLP, (B, 8,
    hidden) for an LSTM, (B, H, W, C) for a CNN."""
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    if cfg.kind == "mlp":
        shape = (batch, cfg.widths[0])
    elif cfg.kind == "lstm":
        shape = (batch, 8, cfg.hidden)
    else:
        shape = (batch, cfg.spatial, cfg.spatial, cfg.conv_channels[0])
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def weight_count(params) -> int:
    """Elements of every leaf, a QTensor counted at its logical shape."""
    if isinstance(params, dict):
        return sum(weight_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(weight_count(v) for v in params)
    if isinstance(params, QTensor):
        return params.shape.numel()
    return params.numel()
