"""Quantized batched serving under a p99 deadline — the paper's production
scenario on the six NN apps it benchmarked (MLP0/1, LSTM0/1, CNN0/1), on
one card.  The twin of ``examples/serve_quantized.py``.

For each app: build the model at Table 1 scale, quantize to int8 (every
FC then runs ``qmatmul_w8a16`` on the card), measure the service-time
curve of the forward captured as a CUDA graph once per batch (the
reference's ``jax.jit``; each batch timed over warm replays with CUDA
events), pick the largest batch meeting the app's deadline (Table 4
policy), then push a pseudo-Poisson request stream through the
BatchQueue and report p99 / throughput.  With ``--device cpu`` the
forward runs eagerly on the CPU, timed by the host clock.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_quantized \\
          [--apps MLP0,MLP1] [--n-requests 150] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.paper_apps import PAPER_APP_CONFIGS
from repro_torch.core import batching as bt
from repro_torch.core.qlinear import W8A16
from repro_torch.core.quant import quantize_tree, tree_weight_bytes
from repro_torch.device import resolve_device
from repro_torch.models import paper_nets as PN
from repro_torch.runtime.graphs import CapturedStep

BATCHES = (1, 8, 32)


def make_forward(app_cfg, mode=W8A16):
    """``forward(params, x) -> y``: ``apply_app`` captured as a CUDA graph
    at its first call of each input shape (run eagerly on the CPU); ``y``
    is a static buffer the next call of that shape overwrites.
    ``forward.captured`` is the ``CapturedStep``."""
    captured = CapturedStep(
        lambda params, cache, x: (PN.apply_app(params, app_cfg, x,
                                               mode=mode),))

    def forward(params, x):
        y, = captured(params, {}, x)
        return y

    forward.captured = captured
    return forward


def time_batches(app_cfg, params, forward, batches=BATCHES, iters=3,
                 device=None) -> dict:
    """{batch: seconds a warm forward}: on the card the mean of ``iters``
    replays between two CUDA events, after the call that captured it;
    on the CPU the host clock over ``iters`` eager calls after one."""
    device = resolve_device(device)
    times = {}
    for b in batches:
        x = PN.app_input(app_cfg, batch=b, device=device)
        forward(params, x)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                forward(params, x)
            end.record()
            end.synchronize()
            times[b] = start.elapsed_time(end) * 1e-3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                forward(params, x)
            times[b] = (time.perf_counter() - t0) / iters
    return times


def fit(times: dict) -> bt.LatencyModel:
    """The reference's latency model of a measured curve."""
    bs = sorted(times)
    per = max((times[bs[-1]] - times[bs[0]]) / (bs[-1] - bs[0]), 1e-9)
    fixed = max(times[bs[0]] - bs[0] * per, 1e-9)
    return bt.LatencyModel("local", fixed * 2, per * 1.5, fixed, per)


def build(name: str, device=None):
    """(config, int8 params, f32 MB): ``name`` at Table 1 size from seed
    0, quantized as the reference does (``min_size=1024``: every FC and
    conv weight)."""
    device = resolve_device(device)
    cfg = PAPER_APP_CONFIGS[name]
    gen = torch.Generator(device=device).manual_seed(0)
    params = PN.init_app(gen, cfg, device=device)
    fp_mb = tree_weight_bytes(params) / 1e6
    return cfg, quantize_tree(params, min_size=1024), fp_mb


def serve(cfg, qparams, n_requests: int, device=None,
          fp_mb: float = float("nan")) -> dict:
    """Measure ``qparams``' curve, choose the batch and serve a trace;
    returns the app's line's numbers (``curve``: seconds a forward by
    batch)."""
    forward = make_forward(cfg)
    curve = time_batches(cfg, qparams, forward, device=device)
    forward.captured.release()
    model = fit(curve)
    # deadline: the app's, or a batch of 8's modeled p99 if that is longer
    deadline = max(cfg.deadline_ms * 1e-3, model.p99_latency(8))
    batch = bt.choose_batch(model, deadline, max_batch=cfg.batch)
    reqs = bt.poisson_arrivals(0.5 * batch / model.service_time(batch),
                               n_requests, deadline)
    recs = bt.BatchQueue(model.service_time, max_batch=batch).run(reqs)
    arrival = {r.rid: r.arrival_s for r in reqs}
    lat = [rec.finish_s - arrival[rid] for rec in recs for rid in rec.rids]
    return {"name": cfg.name, "fp_mb": fp_mb,
            "q_mb": tree_weight_bytes(qparams) / 1e6, "curve": curve,
            "batch": batch, "paper_batch": cfg.batch, "deadline": deadline,
            "p99": bt.p99(lat),
            "rps": len(lat) / max(r.finish_s for r in recs),
            "met": float(np.mean([r.deadlines_met for r in recs]))}


def serve_app(name: str, n_requests: int, device=None) -> dict:
    """Build, quantize, measure and serve one app."""
    cfg, qparams, fp_mb = build(name, device)
    return serve(cfg, qparams, n_requests, device, fp_mb)


def line(r: dict) -> str:
    return (f"{r['name']:6s} weights {r['fp_mb']:6.1f}->{r['q_mb']:6.1f} MB | "
            f"batch={r['batch']:3d} (paper used {r['paper_batch']}) | "
            f"p99 {r['p99']*1e3:7.2f} ms (deadline "
            f"{r['deadline']*1e3:6.1f} ms) | "
            f"{r['rps']:7.1f} req/s | deadline met {r['met']:.0%}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--apps", default="MLP0,MLP1,LSTM1")
    ap.add_argument("--n-requests", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    for name in args.apps.split(","):
        with torch.inference_mode():
            print(line(serve_app(name, args.n_requests, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
