"""Which ``qmatmul_w8a16`` kernel each caller asks for, on the CPU at
reduced size.

The W8A16 wrapper has two kernels on the card: the GEMV, whose rows do
not depend on M, and the ``mma.sync`` tensor-core kernel, whose rows
differ from the GEMV's by f32 rounding.  The engine's bit parity with its
batch-1 reference needs every decode step on one path, so the path is
chosen by caller: the full-sequence ``forward`` asks for ``"mma"`` at
every projection and the LM head, every decode step for ``"gemv"``.
A spy on ``ops.qmatmul`` records the ``path`` each call passes (on the
CPU the plain version runs whatever it is).
"""
import dataclasses

import pytest
import torch

from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core.qlinear import W8A8, W8A16
from repro_torch.core.quant import QTensor, quantize_tree
from repro_torch.kernels import ops
from repro_torch.kernels import qmatmul as K
from repro_torch.launch import serve
from repro_torch.models import registry as R
from repro_torch.runtime import steps as ST

STEPS = ("decode_step", "slot_step", "chunk_step", "decode_loop")
CACHES = ("int8", "paged", "bf16")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def calls(monkeypatch):
    """Every ``ops.qmatmul`` call as (path, W8A8?, out dtype)."""
    seen = []
    real = ops.qmatmul

    def spy(*a, **kw):
        seen.append((kw.get("path", "gemv"), kw.get("x_q") is not None,
                     kw.get("out_dtype")))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "qmatmul", spy)
    return seen


def _model(kv_quant=True):
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=kv_quant)
    gen = torch.Generator().manual_seed(0)
    params = quantize_tree(R.init(gen, cfg, device="cpu"), min_size=2048)
    return cfg, params


@pytest.fixture(scope="module")
def model():
    return _model()


def _cache(cfg, kind, slots=2, s_max=8):
    if kind == "paged":
        bs = 4
        mb = s_max // bs
        cache = R.init_paged_cache(cfg, slots, s_max, bs, slots * mb + 1,
                                   device="cpu")
        cache["block_tables"].copy_(torch.arange(
            1, slots * mb + 1, dtype=torch.int32).reshape(slots, mb))
        return cache
    return R.init_cache(cfg, slots, s_max, device="cpu")


def _run_step(which, cfg, params, cache, mode):
    toks = torch.ones((2, 1), dtype=torch.int32)
    if which == "decode_step":
        ST.make_decode_step(cfg, mode=mode)(
            params, {"tokens": toks, "cache_index": 1}, cache)
    elif which == "slot_step":
        ST.make_slot_decode_step(cfg, mode=mode)(
            params, toks, cache, torch.tensor([0, 3], dtype=torch.int32),
            torch.tensor([True, True]))
    elif which == "chunk_step":
        ST.make_prefill_chunk_step(cfg, mode=mode, chunk=4)(
            params, [1, 2, 3, 0], cache, 1, 0, 3)
    else:
        ST.make_decode_loop(cfg, mode=mode, num_tokens=2)(
            params, toks, cache, 0)


def test_forward_w8a16_asks_for_mma_everywhere(model, calls):
    """Every projection of every layer and the LM head (f32 out)."""
    cfg, params = model
    out = ST.make_prefill_step(cfg, mode=W8A16)(
        params, {"tokens": torch.ones((2, 5), dtype=torch.int32)})
    assert out.shape == (2, 5, cfg.vocab)
    assert [p for p, _, _ in calls] == ["mma"] * (6 * cfg.n_layers + 1)
    assert calls[-1][2] == torch.float32
    assert not any(q for _, q, _ in calls)


@pytest.mark.parametrize("cache_kind", CACHES)
@pytest.mark.parametrize("which", STEPS)
def test_decode_paths_ask_for_gemv_only(model, calls, which, cache_kind):
    """The decode step, the slot tick, the chunk step and the decode loop,
    on the int8 (contiguous and paged) and the bf16 cache: every W8A16
    matmul, the LM head included, through the GEMV."""
    cfg, params = model
    if cache_kind == "bf16":
        cfg = dataclasses.replace(cfg, kv_quant=False)
    _run_step(which, cfg, params, _cache(cfg, cache_kind), W8A16)
    assert calls and {p for p, _, _ in calls} == {"gemv"}


@pytest.mark.parametrize("which", STEPS)
def test_decode_step_keeps_the_gemv_whatever_the_mode_asks(model, calls,
                                                            which):
    """A mode that asks for the tensor cores does not take a decode step
    off the GEMV: the step pins the path itself."""
    cfg, params = model
    mode = dataclasses.replace(W8A16, w8a16_path="mma")
    _run_step(which, cfg, params, _cache(cfg, "int8"), mode)
    assert calls and {p for p, _, _ in calls} == {"gemv"}


def test_w8a8_is_unaffected(model, calls):
    """Under W8A8 the projections take the integer path (routed by M, not
    by caller) and the forward's LM head stays on the GEMV; the decode
    step asks for the GEMV too."""
    cfg, params = model
    ST.make_prefill_step(cfg, mode=W8A8)(
        params, {"tokens": torch.ones((2, 5), dtype=torch.int32)})
    n = 6 * cfg.n_layers
    assert [(p, q) for p, q, _ in calls] == [("gemv", True)] * n + [
        ("gemv", False)]
    del calls[:]
    _run_step("decode_step", cfg, params, _cache(cfg, "int8"), W8A8)
    assert {p for p, _, _ in calls} == {"gemv"}


def test_engine_never_asks_for_mma(calls):
    """The slot engine (warm-up, ticks and chunked prefill), contiguous
    and paged."""
    cfg, params = _model()
    reqs = E.synthetic_requests(4, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=5, max_new_tokens=3)
    for kw in ({}, {"block_size": 4}):
        eng = E.Engine(cfg, params, mode=W8A16, num_slots=2, max_seq=8,
                       prefill_chunk=4, device="cpu", **kw)
        eng.warmup()
        rep = eng.serve(reqs)
        assert all(r.status == "ok" for r in rep.results)
    assert calls and {p for p, _, _ in calls} == {"gemv"}


def test_serve_takes_mma_only_in_the_service_curve(calls, monkeypatch):
    """The serve CLI under --quant w8a16: the service curve's forwards ask
    for the tensor cores at every call, the decode loop and the engine
    never."""
    in_curve = []
    real = serve.measure_service_curve

    def curve(*a, **kw):
        start = len(calls)
        try:
            return real(*a, **kw)
        finally:
            in_curve.extend(range(start, len(calls)))

    monkeypatch.setattr(serve, "measure_service_curve", curve)
    args = ["--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
            "--seq", "4", "--max-batch", "2", "--n-requests", "3",
            "--decode-tokens", "2", "--prompt-len", "3", "--gen-tokens",
            "2", "--prefill-chunk", "2", "--deadline-ms", "60000",
            "--quant", "w8a16"]
    assert serve.run(serve.parse_args(args)).code == 0
    inside = {calls[i][0] for i in in_curve}
    outside = {p for i, (p, _, _) in enumerate(calls)
               if i not in set(in_curve)}
    assert inside == {"mma"} and outside == {"gemv"}


def test_cpu_runs_the_plain_version_whatever_the_path():
    gen = torch.Generator().manual_seed(3)
    w = torch.randint(-127, 128, (64, 24), generator=gen, dtype=torch.int8)
    q = QTensor(w, torch.rand((1, 24), generator=gen) * 0.01 + 1e-3)
    x = torch.randn((5, 64), generator=gen).to(torch.bfloat16)
    calls, launches = K.qmatmul_w8a16_ref.calls, K.qmatmul_w8a16.launches
    outs = [ops.qmatmul(x, q, activation="gelu", path=p)
            for p in K.W8A16_PATHS]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert K.qmatmul_w8a16_ref.calls == calls + len(K.W8A16_PATHS)
    assert K.qmatmul_w8a16.launches == launches


def test_wrapper_refuses_unknown_paths_and_cpu_tensors():
    w = torch.zeros((8, 8), dtype=torch.int8)
    x = torch.zeros((1, 8), dtype=torch.bfloat16)
    before = dict(K.qmatmul_w8a16.launches_by_path)
    for path in K.W8A16_PATHS:
        with pytest.raises(ValueError, match="CUDA"):
            K.qmatmul_w8a16_on_path(path, x, w, torch.ones(8))
    with pytest.raises(ValueError, match="path"):
        K.qmatmul_w8a16_on_path("wmma", x, w, torch.ones(8))
    with pytest.raises(ValueError, match="bf16"):
        K.qmatmul_w8a16_on_path("mma", x.float(), w, torch.ones(8))
    with pytest.raises(ValueError, match="path"):
        ops.qmatmul(x, QTensor(w, torch.ones((1, 8))), path="wmma")
    assert K.qmatmul_w8a16.launches_by_path == before
    assert set(before) == set(K.W8A16_PATHS) == {"gemv", "mma"}
