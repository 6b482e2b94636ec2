"""The port's twins of ``examples/serve_quantized.py`` and
``examples/quickstart.py``, on the CPU.

Each runs on the card unless ``--device cpu`` is given, and without a
card and without ``--device`` it refuses (no silent CPU fallback).  On
the CPU every int8 matmul is the plain version, which computes a row at a
time (so that a row's bits do not depend on the batch): LSTM1's curve at
batch 32 takes most of a minute on one thread.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import batching as bt
from repro_torch.examples import quickstart, serve_quantized

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_quantized_on_cpu_prints_a_line_per_app(capsys):
    rc = serve_quantized.main(["--device", "cpu", "--apps", "MLP1,LSTM1",
                               "--n-requests", "20"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert [line.split()[0] for line in out] == ["MLP1", "LSTM1"]
    for line in out:
        assert "deadline met" in line and "req/s" in line and "p99" in line
    # Table 1's weights, f32 -> int8 (4 bytes -> 1 and a scale a column)
    assert "weights   20.0->   5.0 MB" in out[0]
    assert "weights  136.4->  34.3 MB" in out[1]


def test_serve_quantized_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_quantized",
         "--device", "cpu", "--apps", "MLP1", "--n-requests", "20"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("MLP1 ")


def test_serve_app_follows_the_reference_s_policy():
    """The fit, the deadline, the chosen batch and the served trace follow
    the reference's formulas on the measured curve."""
    r = serve_quantized.serve_app("MLP1", 20, device="cpu")
    model = serve_quantized.fit(r["curve"])
    assert sorted(r["curve"]) == list(serve_quantized.BATCHES)
    assert r["deadline"] == max(7e-3, model.p99_latency(8))
    assert r["batch"] == bt.choose_batch(model, r["deadline"], max_batch=168)
    assert 8 <= r["batch"] <= 168 and 0.0 <= r["met"] <= 1.0
    assert r["p99"] > 0 and r["rps"] > 0


def test_fit_is_the_reference_s_latency_model():
    model = serve_quantized.fit({1: 1e-3, 8: 2.4e-3, 32: 7.2e-3})
    per = (7.2e-3 - 1e-3) / 31
    fixed = 1e-3 - per
    assert model == bt.LatencyModel("local", fixed * 2, per * 1.5, fixed,
                                    per)


def test_quickstart_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for head in ("== 1. train", "== 2. post-training int8",
                 "== 3. latency-bounded serving", "== 4. TPU v1"):
        assert head in out
    assert "TPU      batch= 200" in out
    assert "ridge 1349 ops/byte" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("main", [serve_quantized.main, quickstart.main])
def test_the_twins_need_the_card_unless_told_cpu(main):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
