"""Quickstart: the paper's full workflow in one script, on one card.  The
twin of ``examples/quickstart.py``.

1. train a small LM (f32 params, bf16 products),
2. post-training int8 quantization (the paper's technique),
3. latency-bounded batched serving (Table 4 policy),
4. the TPU v1 analytical model: roofline + design sweep highlights.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import batching as bt
from repro_torch.core import perfmodel as pm
from repro_torch.core.qlinear import W8A16
from repro_torch.core.quant import quantize_tree, tree_weight_bytes
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models import registry as R
from repro_torch.optim import make_optimizer
from repro_torch.runtime import steps as ST


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    device = resolve_device(parse_args(argv).device)
    cfg = get_config("starcoder2-3b").reduced()
    print(f"== 1. train {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) ==")
    gen = torch.Generator(device=device).manual_seed(0)
    params = R.init(gen, cfg, device=device)
    opt = make_optimizer("adamw", lr=3e-3)
    state = opt.init(params)
    step = ST.make_train_step(cfg, opt)
    data = SyntheticLMData(cfg.vocab, 64, 8, seed=0)
    losses = []
    for t in range(40):
        tokens, labels = data.batch_at(t)
        batch = {"tokens": torch.from_numpy(tokens).to(device),
                 "labels": torch.from_numpy(labels).to(device)}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        if t % 10 == 0:
            print(f"  step {t:3d}  loss {losses[-1]:.3f}")
    print(f"  loss {np.mean(losses[:5]):.3f} -> {np.mean(losses[-5:]):.3f}")

    print("== 2. post-training int8 quantization ==")
    with torch.no_grad():
        fp_bytes = tree_weight_bytes(params)
        qparams = quantize_tree(params, min_size=2048)
        print(f"  weights {fp_bytes/1e6:.1f} MB -> "
              f"{tree_weight_bytes(qparams)/1e6:.1f} MB")
        tokens, _ = data.batch_at(99)
        b = {"tokens": torch.from_numpy(tokens).to(device)}
        fp = R.apply_forward(params, cfg, b)
        qi = R.apply_forward(qparams, cfg, b, mode=W8A16)
        agree = float((fp.argmax(-1) == qi.argmax(-1)).float().mean())
    print(f"  int8 vs fp top-1 agreement: {agree:.1%}")

    print("== 3. latency-bounded serving (Table 4 policy) ==")
    for model, cap in ((bt.TABLE4_CPU, 64), (bt.TABLE4_GPU, 64),
                       (bt.TABLE4_TPU, 250)):
        bsz, lat, ips, frac = bt.table4_row(model, 7e-3, max_batch=cap)
        print(f"  {model.name:8s} batch={bsz:4d} p99={lat*1e3:5.1f} ms "
              f"IPS={ips:9,.0f} ({frac:.0%} of max)")

    print("== 4. TPU v1 analytical model highlights ==")
    print(f"  peak {pm.TPU_V1.peak_ops/1e12:.0f} TOPS, ridge "
          f"{pm.TPU_V1.ridge_ops_per_byte:.0f} ops/byte (paper: 92, ~1350)")
    for name in ("MLP0", "CNN0"):
        r = pm.simulate(pm.APP_BY_NAME[name])
        print(f"  {name}: modeled {r.tops:.1f} TOPS "
              f"(paper {pm.APP_BY_NAME[name].paper_tops})")
    g = pm.tpu_prime_gains()
    print(f"  TPU' (GDDR5): GM {g['gddr5_gm']:.1f}x / WM "
          f"{g['gddr5_wm']:.1f}x (paper: 2.6 / 3.9)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
