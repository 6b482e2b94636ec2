"""Training launcher (the port of ``repro/launch/train.py``): an end-to-end
loop with checkpoints, resume and the step watchdog, on one card.

    python -m repro_torch.launch.train --arch starcoder2-3b --reduced \
        --steps 200 --ckpt-dir /tmp/ckpt --resume auto --device cpu

Params come from ``registry.init`` on the device with a ``torch.Generator``
seeded by ``--seed``; the optimizer (``--optimizer adamw`` or
``adafactor``) runs on the reference's cosine schedule (20 warm-up steps,
decay to 0 at ``--steps``); each step is
``runtime/steps.py::make_train_step`` (every attention layer's forward
the flash-attention kernel on the card, each layer rematerialized).
Every ``--ckpt-every`` steps the params and the optimizer's state are
saved in the background (``checkpoint/manager.py``), with the data step
as metadata.  Kill it at any step: rerunning with ``--resume auto``
restores the newest committed checkpoint and resumes the deterministic
data stream at its data step.  Without ``--device`` it runs on the card
(and fails without one); ``--device cpu`` runs the kernels' plain
versions on the CPU.

``--arch`` takes the token-only families (dense, moe, ssm, hybrid):

    python -m repro_torch.launch.train --arch mamba2-1.3b --steps 10

The batch is the synthetic stream's tokens and labels, as the
reference's launcher builds it, so an encdec or vlm config, whose
forward also reads source embeddings, is refused before anything is
built (``runtime/steps.py::make_train_step`` trains those with a batch
that carries them).  The reference's mesh and sharding rules are not
ported (ROADMAP queue 1, item 15): the model trains on one device.
``--grad-compression int8`` raises, naming that item.  The exit code is the reference's: 0 when the
mean loss of the last 5 steps is below that of the first 5 (or the run
resumed), else 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, read_metadata
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models import registry as R
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.runtime import prng as P
from repro_torch.runtime import steps as ST
from repro_torch.runtime.watchdog import StepTimer, StepWatchdog


# the families whose batch needs more than tokens and labels: the source
# embeddings their forward reads (``configs/base.py::input_specs``)
SOURCE_FAMILIES = {"encdec": "encoder_embeds", "vlm": "vision_embeds"}


@dataclasses.dataclass
class TrainRun:
    """What a run did: the exit code, the first step it ran (the restored
    checkpoint's data step, or 0), each step's loss and wall seconds."""
    rc: int
    start_step: int
    losses: List[float]
    step_seconds: List[float]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def train(argv=None) -> TrainRun:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if cfg.family in SOURCE_FAMILIES:
        raise ValueError(
            f"--arch {args.arch}: the {cfg.family} family's forward reads "
            f"{SOURCE_FAMILIES[cfg.family]} besides the tokens, and this "
            f"launcher's batch is the synthetic stream's tokens and labels "
            f"alone (the reference's launcher builds no source embeddings "
            f"either); train it through runtime.steps.make_train_step with "
            f"a batch that carries them")
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    opt = make_optimizer(args.optimizer,
                         lr=cosine_schedule(args.lr, 20, args.steps))
    train_step = ST.make_train_step(
        cfg, opt, grad_compression=None if args.grad_compression == "none"
        else args.grad_compression)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = R.init(gen, cfg, device=device)
    opt_state = opt.init(params)

    data = SyntheticLMData(cfg.vocab, args.seq_len, args.batch,
                           seed=args.seed)
    start_step = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume == "auto":
        step, restored = ckpt.restore_latest({"params": params,
                                              "opt": opt_state})
        if step is not None:
            start_step = read_metadata(args.ckpt_dir, step)["data_step"]
            params, opt_state = restored["params"], restored["opt"]
            print(f"[resume] restored step {step} from {args.ckpt_dir}")

    key = P.PRNGKey(args.seed, device=device)
    watchdog = StepWatchdog()
    losses: List[float] = []
    seconds: List[float] = []
    try:
        for step in range(start_step, args.steps):
            tokens, labels = data.batch_at(step)
            batch = {"tokens": torch.from_numpy(tokens).to(device),
                     "labels": torch.from_numpy(labels).to(device)}
            with StepTimer() as t:
                params, opt_state, metrics = train_step(
                    params, opt_state, batch, P.fold_in(key, step))
                loss = float(metrics["loss"])
            warn = watchdog.record(t.elapsed)
            if warn:
                print(f"[watchdog] step {step}: {warn}")
            losses.append(loss)
            seconds.append(t.elapsed)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{t.elapsed*1e3:.0f} ms")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save_async(step + 1,
                                {"params": params, "opt": opt_state},
                                metadata={"data_step": step + 1})
    finally:
        if ckpt:                      # a save in flight is finished
            ckpt.wait()
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    print(f"[done] loss {first:.3f} -> {last:.3f} over "
          f"{len(losses)} steps; straggler warnings: {watchdog.slow_steps}")
    rc = 0 if (last < first or start_step > 0) else 1
    return TrainRun(rc, start_step, losses, seconds)


def main(argv=None) -> int:
    return train(argv).rc


if __name__ == "__main__":
    sys.exit(main())
