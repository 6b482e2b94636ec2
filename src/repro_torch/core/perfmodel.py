"""Analytical performance model of the TPU v1 — Section 7 of the paper.

A copy of ``repro/core/perfmodel.py`` (pure Python; it runs on no
device), reading the port's ``core/quant.py::bits_speed_factor``.

The paper built a cycle model of the TPU ("Like an FPU, the TPU coprocessor
has a relatively easy microarchitecture to evaluate") that matched hardware
performance counters within 8% on average (Table 7), then used it to sweep
memory bandwidth / clock / matrix-unit size (Figure 11) and to evaluate the
hypothetical TPU' with GDDR5 weight memory.

This module rebuilds that model from the microarchitectural facts in the
paper and uses it for the same three purposes:

1. reproduce the Table 3 cycle-breakdown / TeraOps rows per app,
2. reproduce the Figure 11 sensitivity sweep and the TPU' result,
3. provide the service-time model consumed by `core.batching` (Table 4).

Microarchitectural facts encoded (all quoted from the paper):
- 256x256 8-bit MACs @ 700 MHz -> 92 TOPS peak (2 ops per MAC).
- Weight tiles are dim^2 bytes (64 KiB at 8 bit); shifting a tile into the
  array takes `dim` (=256) cycles; the Weight FIFO is 4 tiles deep and
  double-buffers fetches against compute.
- Weight Memory: 8 GiB DDR3 @ 34 GB/s  ->  34e9/700e6 = 48.6 B/cycle, so one
  tile fetch is 65536/48.6 = ~1350 cycles: exactly the paper's roofline ridge
  ("operations per byte need to reach peak performance is ~1350").
- 4096 256-wide 32-bit accumulators = 2048 usable rows double-buffered
  ("we picked 4096 by ... ~1350, rounded up to 2048 and then duplicated").
- Matrix op streams B rows through a resident tile in B pipelined cycles.
- 8w x 16a or 16w x 8a run at half speed; 16x16 at quarter (quant.bits_speed_factor).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.quant import bits_speed_factor


# ---------------------------------------------------------------------------
# Hardware description
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPUHW:
    """Parametric TPU v1-like design point."""
    matrix_dim: int = 256
    clock_hz: float = 700e6
    mem_bw: float = 34e9            # weight-memory bytes/s
    n_accumulators: int = 4096      # matrix_dim-wide 32-bit accumulator rows
    fifo_tiles: int = 4
    w_bits: int = 8
    a_bits: int = 8

    @property
    def peak_ops(self) -> float:
        """Peak ops/s (MAC = 2 ops), derated for wide operands."""
        return (2.0 * self.matrix_dim ** 2 * self.clock_hz
                * bits_speed_factor(self.w_bits, self.a_bits))

    @property
    def bytes_per_cycle(self) -> float:
        return self.mem_bw / self.clock_hz

    @property
    def tile_bytes(self) -> int:
        return self.matrix_dim ** 2 * self.w_bits // 8

    @property
    def tile_fetch_cycles(self) -> float:
        return self.tile_bytes / self.bytes_per_cycle

    @property
    def ridge_ops_per_byte(self) -> float:
        """Roofline ridge point in ops-per-weight-byte (paper: ~1350 in MAC
        units; we report MACs/byte to match Fig. 5's x-axis)."""
        return self.peak_ops / 2.0 / self.mem_bw

    def scaled(self, *, memory: float = 1.0, clock: float = 1.0,
               matrix: float = 1.0, accumulators: float = 1.0) -> "TPUHW":
        return dataclasses.replace(
            self,
            mem_bw=self.mem_bw * memory,
            clock_hz=self.clock_hz * clock,
            matrix_dim=int(round(self.matrix_dim * matrix)),
            n_accumulators=int(round(self.n_accumulators * accumulators)),
        )


TPU_V1 = TPUHW()
# TPU': "Designing an interface circuit for GDDR5 memory, as in the K80,
# would improve Weight Memory bandwidth by more than a factor of five,
# shifting its roofline ridge point from 1350 to 250."  34 * 1350/250 = 183.6.
TPU_PRIME = TPU_V1.scaled(memory=1350.0 / 250.0)


# ---------------------------------------------------------------------------
# Workload description (Table 1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                # "fc" | "conv" | "vector"
    d_in: int = 0
    d_out: int = 0
    count: int = 1           # identical layers collapsed
    reuse: float = 1.0       # spatial weight reuse (conv output positions)
    mac_utilization: float = 1.0  # shallow-feature-depth derating (CNN1)


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """One of the six production NNs; dims chosen to match Table 1's weight
    counts and ops/weight-byte, plus details quoted in the text (600x600
    LSTM1 matrices, CNN1's four FC layers at intensity 32, ...)."""
    name: str
    layers: Tuple[LayerSpec, ...]
    batch: int
    nonmatrix_frac: float    # Table 3 row 6
    share: float             # deployment share (Table 1 last column)
    paper_tops: float        # Table 3 row 9 (validation target)
    raw_frac: float = 0.0    # Table 3 row 7, serialized when raw_serial
    raw_serial: bool = False  # matrix unit idles on RAW deps (LSTM1/CNN1 text)
    sync_cycles_per_layer: float = 0.0  # "delay slot" sync exposure (§2)

    @property
    def weight_bytes(self) -> int:
        return sum(l.d_in * l.d_out * l.count for l in self.layers
                   if l.kind != "vector")

    @property
    def macs_per_batch(self) -> float:
        return sum(l.d_in * l.d_out * l.count * self.batch * l.reuse
                   for l in self.layers if l.kind != "vector")

    @property
    def ops_per_weight_byte(self) -> float:
        """The paper's operational intensity (MACs per weight byte)."""
        return self.macs_per_batch / self.weight_bytes


def _fc(d_in, d_out, count=1, **kw):
    return LayerSpec("fc", d_in, d_out, count, **kw)


def _conv(d_in, d_out, count=1, reuse=1.0, **kw):
    return LayerSpec("conv", d_in, d_out, count, reuse=reuse, **kw)


# Layer dims reverse-engineered to satisfy Table 1 (weights, ops/byte, batch)
# and the quoted structural details; nonmatrix_frac from Table 3 row 6.
PAPER_APPS: Tuple[AppSpec, ...] = (
    AppSpec("MLP0", (_fc(2000, 2000, 5),), batch=200,
            nonmatrix_frac=0.175, share=0.305, paper_tops=12.3),
    AppSpec("MLP1", (_fc(1118, 1118, 4),), batch=168,
            nonmatrix_frac=0.319, share=0.305, paper_tops=9.7),
    AppSpec("LSTM0", (_fc(1472, 1472, 24),), batch=64,
            nonmatrix_frac=0.179, share=0.145, paper_tops=3.7),
    # LSTM1: "Consider the 600x600 matrix used in LSTM1" — 37 FC layers of
    # 600x1536 give the 34M weights of Table 1 with heavy tile fragmentation.
    # Cross-timestep RAW dependences expose per-layer "delay slots" (§2); the
    # sync exposure is calibrated to the Table 3 counters, as the paper's own
    # model was calibrated against hardware counters.
    AppSpec("LSTM1", (_fc(600, 1536, 37),), batch=96,
            nonmatrix_frac=0.103, share=0.145, paper_tops=2.8,
            raw_frac=0.106, raw_serial=True, sync_cycles_per_layer=10800),
    AppSpec("CNN0", (_conv(707, 707, 16, reuse=361.0),), batch=8,
            nonmatrix_frac=0.218, share=0.025, paper_tops=86.0),
    # CNN1: 72 conv layers (~30M weights, "some layers have shallow feature
    # depths" -> half the MACs useful) + 4 FC layers (~70M weights) that "run
    # at an operational intensity of just 32"; "23% of cycles have stalls for
    # RAW dependences in the pipeline" -> serialized.
    AppSpec("CNN1", (_conv(646, 646, 72, reuse=180.0, mac_utilization=0.487),
                     _fc(2958, 5916, 4)), batch=32,
            nonmatrix_frac=0.187, share=0.025, paper_tops=14.1,
            raw_frac=0.228, raw_serial=True),
)

APP_BY_NAME: Dict[str, AppSpec] = {a.name: a for a in PAPER_APPS}


# ---------------------------------------------------------------------------
# Cycle model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PerfResult:
    app: str
    total_cycles: float
    active_cycles: float
    stall_cycles: float
    shift_cycles: float
    nonmatrix_cycles: float
    useful_macs: float
    time_s: float
    tops: float                  # 2*useful_macs / time, in 1e12 ops/s
    ips: float                   # inferences (batch items) per second

    @property
    def active_frac(self):
        return self.active_cycles / self.total_cycles

    @property
    def stall_frac(self):
        return self.stall_cycles / self.total_cycles

    @property
    def shift_frac(self):
        return self.shift_cycles / self.total_cycles

    @property
    def nonmatrix_frac(self):
        return self.nonmatrix_cycles / self.total_cycles


# Fraction of non-matrix work hidden by overlapped execution ("Computation is
# often done one layer at a time, with overlapped execution allowing the
# matrix multiply unit to hide most non-critical-path operations", §2).
NONMATRIX_OVERLAP = 0.5


def _layer_cycles(layer: LayerSpec, batch: int, hw: TPUHW,
                  sync: float = 0.0):
    """Cycles for one matrix layer: (time, active, stall, shift, useful_macs).

    Tiling: ceil(d_in/dim) x ceil(d_out/dim) weight tiles.  The array streams
    `rows = batch*reuse` inputs per tile; the accumulators bound the rows in
    flight to n_acc/2 (double-buffered), so longer streams split into chunks.
    The Read_Weights DMA is decoupled (access/execute, [Smi82]), so the layer
    runs in max(total fetch, total compute) — fetches stream ahead through
    the 4-deep Weight FIFO.  Multi-chunk layers whose tile working set
    exceeds the FIFO must re-fetch weight tiles once per chunk.
    Shifting a tile into the array costs `dim` cycles, exposed only when the
    stream is too short to hide it.
    """
    dim = hw.matrix_dim
    speed = bits_speed_factor(hw.w_bits, hw.a_bits)
    row_tiles = math.ceil(layer.d_in / dim)
    col_tiles = math.ceil(layer.d_out / dim)
    tiles = row_tiles * col_tiles
    rows_total = batch * layer.reuse
    chunk_cap = max(1, hw.n_accumulators // 2)
    n_chunks = max(1, math.ceil(rows_total / chunk_cap))
    refetch = n_chunks if (n_chunks > 1 and tiles > hw.fifo_tiles) else 1

    fetch_total = tiles * refetch * hw.tile_fetch_cycles
    compute_total = tiles * rows_total / speed      # wide operands derate
    # Shift exposure: per (tile, chunk), dim cycles hidden under the larger
    # of compute-per-tile and fetch-per-tile; exposed for short streams.
    per_tile_compute = (rows_total / n_chunks) / speed
    shift_exposed = tiles * refetch * max(
        0.0, min(dim, hw.tile_fetch_cycles) - per_tile_compute)
    shift_exposed = min(shift_exposed, tiles * refetch * dim)

    time = max(fetch_total, compute_total + shift_exposed) + sync
    active = compute_total
    shift = min(tiles * refetch * dim, max(0.0, time - active))
    stall = max(0.0, time - active - shift)
    useful = rows_total * layer.d_in * layer.d_out * layer.mac_utilization
    c = layer.count
    return time * c, active * c, stall * c, shift * c, useful * c


def simulate(app: AppSpec, hw: TPUHW = TPU_V1) -> PerfResult:
    matrix_time = active = stall = shift = useful = 0.0
    for layer in app.layers:
        if layer.kind == "vector":
            continue
        t, a, st, sh, u = _layer_cycles(layer, app.batch, hw,
                                        sync=app.sync_cycles_per_layer)
        matrix_time += t
        active += a
        stall += st
        shift += sh
        useful += u
    # Serialized overheads: the un-overlappable half of non-matrix work, plus
    # RAW-dependence pipeline stalls for apps where the text reports the
    # matrix unit idling on them.
    serial_frac = (1.0 - NONMATRIX_OVERLAP) * app.nonmatrix_frac
    if app.raw_serial:
        serial_frac += app.raw_frac
    total = matrix_time / max(1e-9, 1.0 - serial_frac)
    nonmatrix = total - matrix_time
    time_s = total / hw.clock_hz
    tops = 2.0 * useful / time_s / 1e12
    ips = app.batch / time_s
    return PerfResult(app.name, total, active, stall, shift, nonmatrix,
                      useful, time_s, tops, ips)


def service_time(app: AppSpec, hw: TPUHW = TPU_V1, batch=None) -> float:
    """Seconds to run one batch of `batch` items (for core.batching)."""
    if batch is None:
        return simulate(app, hw).time_s
    return simulate(dataclasses.replace(app, batch=batch), hw).time_s


# ---------------------------------------------------------------------------
# Roofline (Figure 5) and sensitivity (Figure 11)
# ---------------------------------------------------------------------------

def roofline_point(app: AppSpec, hw: TPUHW = TPU_V1):
    """(intensity MACs/weight-byte, attainable TOPS, achieved TOPS)."""
    intensity = app.ops_per_weight_byte
    attain = min(hw.peak_ops, 2.0 * intensity * hw.mem_bw) / 1e12
    achieved = simulate(app, hw).tops
    return intensity, attain, achieved


def weighted_mean_perf(hw: TPUHW, baseline: TPUHW = TPU_V1,
                       weighted: bool = True) -> float:
    """Mean relative performance vs baseline over the six apps (Fig. 11)."""
    rels = []
    ws = []
    for app in PAPER_APPS:
        rels.append(simulate(app, hw).tops / simulate(app, baseline).tops)
        ws.append(app.share if weighted else 1.0)
    if weighted:
        return sum(r * w for r, w in zip(rels, ws)) / sum(ws)
    return math.exp(sum(math.log(r) for r in rels) / len(rels))


FIG11_KNOBS = ("memory", "clock+", "clock", "matrix+", "matrix")


def fig11_sweep(scales: Sequence[float] = (0.25, 0.5, 1.0, 2.0, 4.0),
                weighted: bool = True) -> Dict[str, List[Tuple[float, float]]]:
    """Weighted-mean relative perf as each knob scales 0.25x..4x."""
    out: Dict[str, List[Tuple[float, float]]] = {k: [] for k in FIG11_KNOBS}
    for s in scales:
        out["memory"].append((s, weighted_mean_perf(
            TPU_V1.scaled(memory=s), weighted=weighted)))
        out["clock"].append((s, weighted_mean_perf(
            TPU_V1.scaled(clock=s), weighted=weighted)))
        out["clock+"].append((s, weighted_mean_perf(
            TPU_V1.scaled(clock=s, accumulators=s), weighted=weighted)))
        out["matrix"].append((s, weighted_mean_perf(
            TPU_V1.scaled(matrix=s), weighted=weighted)))
        out["matrix+"].append((s, weighted_mean_perf(
            TPU_V1.scaled(matrix=s, accumulators=s * s), weighted=weighted)))
    return out


def tpu_prime_gains() -> Dict[str, float]:
    """The TPU' evaluation: GDDR5 memory, optional 1.05 GHz clock.

    Paper: GDDR5 alone -> GM 2.6 / WM 3.9; clock alone -> ~no change;
    both -> GM 2.9 but WM unchanged, 'so TPU' just has faster memory'.
    """
    gddr5 = TPU_V1.scaled(memory=1350.0 / 250.0)
    clock15 = TPU_V1.scaled(clock=1.5, accumulators=1.5)
    both = TPU_V1.scaled(memory=1350.0 / 250.0, clock=1.5, accumulators=1.5)
    return {
        "gddr5_gm": weighted_mean_perf(gddr5, weighted=False),
        "gddr5_wm": weighted_mean_perf(gddr5, weighted=True),
        "clock1.5_gm": weighted_mean_perf(clock15, weighted=False),
        "clock1.5_wm": weighted_mean_perf(clock15, weighted=True),
        "both_gm": weighted_mean_perf(both, weighted=False),
        "both_wm": weighted_mean_perf(both, weighted=True),
    }


# ---------------------------------------------------------------------------
# Unified Buffer occupancy (Table 8)
# ---------------------------------------------------------------------------

def unified_buffer_mib(app: AppSpec) -> float:
    """Modeled UB footprint: double-buffered input+output activations of the
    hungriest layer — rows in flight (bounded by the 2048-row accumulator
    stream) x (d_in + d_out) bytes, x2 for ping-pong."""
    mib = 0.0
    for l in app.layers:
        if l.kind == "vector":
            continue
        rows = min(2048, int(app.batch * l.reuse))
        mib = max(mib, 2.0 * rows * (l.d_in + l.d_out) / 2**20)
    return mib
