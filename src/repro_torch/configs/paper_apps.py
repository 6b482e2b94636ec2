"""The paper's six production NN apps (Table 1) as buildable model configs.

A copy of ``repro/configs/paper_apps.py``: these are the workload the TPU
was evaluated on; ``models/paper_nets.py`` builds runnable PyTorch
versions whose weight counts match Table 1 (the roofline-relevant
quantity), and ``examples/serve_quantized.py`` runs them through the
quantized path with the Table 4 batch scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PaperAppConfig:
    name: str
    kind: str                 # "mlp" | "lstm" | "cnn"
    batch: int                # paper's TPU batch size (Table 1)
    deadline_ms: float        # response-time bound (7 ms for user-facing)
    # mlp: layer widths; lstm: (n_cells, width); cnn: conv spec
    widths: Tuple[int, ...] = ()
    n_cells: int = 0
    hidden: int = 0
    conv_channels: Tuple[int, ...] = ()
    spatial: int = 0          # input HxW
    fc_tail: Tuple[int, ...] = ()
    weights_target_m: float = 0.0   # Table 1 "Weights" column


PAPER_APP_CONFIGS = {
    # 5 FC layers, 20M weights, batch 200 (RankBrain-like)
    "MLP0": PaperAppConfig("MLP0", "mlp", batch=200, deadline_ms=7.0,
                           widths=(2000,) * 5, weights_target_m=20.0),
    # 4 FC layers, 5M weights, batch 168
    "MLP1": PaperAppConfig("MLP1", "mlp", batch=168, deadline_ms=7.0,
                           widths=(1118,) * 4, weights_target_m=5.0),
    # 52M weights across 24 gate matmuls -> 6 cells, width 1042
    "LSTM0": PaperAppConfig("LSTM0", "lstm", batch=64, deadline_ms=10.0,
                            n_cells=6, hidden=1042, weights_target_m=52.0),
    # 34M weights; the paper cites its 600-wide matrices
    "LSTM1": PaperAppConfig("LSTM1", "lstm", batch=96, deadline_ms=7.0,
                            n_cells=9, hidden=688, weights_target_m=34.0),
    # AlphaGo-style: 19x19 board, 16 conv layers of 256 3x3 filters ~ 8M
    "CNN0": PaperAppConfig("CNN0", "cnn", batch=8, deadline_ms=10.0,
                           conv_channels=(256,) * 16, spatial=19,
                           weights_target_m=8.0),
    # Inception-like: 72 conv (~28M) + 4 FC (~72M) = 100M
    "CNN1": PaperAppConfig("CNN1", "cnn", batch=32, deadline_ms=10.0,
                           conv_channels=(208,) * 72, spatial=28,
                           fc_tail=(3700, 7400, 3700, 1000),
                           weights_target_m=100.0),
}
