"""The port's serve launcher (``python -m repro_torch.launch.serve``) on the
CPU at reduced size: the reference CLI's single-model path end to end —
quantize, the service curve through ``forward``, the Table 4 batch choice,
the decode loop, and the engine under the wall clock or the ``--sim``
simulator, the overload flags, the paged bf16 cache (--block-size,
--num-blocks, --shared-prefix-len), speculation (--spec-k with
--draft-layers or --draft), multiplexing (--models, --model-quota) and
the replica router (--replicas), scale-out (--tp) — and its refusals."""
import pytest
import torch

from repro_torch.launch import serve

# small enough for the CPU: the curve measures batches 1, 4 and 16 of
# 8 tokens; 6 requests through the engine
BASE = ["--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
        "--seq", "8", "--max-batch", "4", "--n-requests", "6",
        "--decode-tokens", "4", "--prompt-len", "5", "--gen-tokens", "4",
        "--prefill-chunk", "4", "--deadline-ms", "60000"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("quant", ["w8a16", "w8a8", "fp"])
def test_serve_runs_end_to_end(quant, capsys):
    res = serve.run(serve.parse_args(BASE + ["--quant", quant]))
    assert res.code == 0
    out = capsys.readouterr().out
    for tag in (["[quant]"] if quant != "fp" else []) + [
            "[serve] service curve", "[serve] service(1)=", "[decode]",
            "[engine] achieved p99", "[engine] time-to-first-token"]:
        assert tag in out, tag
    assert sorted(res.curve) == [1, 4, 16]
    assert all(t > 0 for t in res.curve.values())
    assert 1 <= res.batch <= 4
    assert res.engine.num_slots == res.batch       # 4 is on the ladder
    assert res.decode_tokens_per_s > 0
    rep = res.report
    assert len(rep.results) == 6
    assert all(r.status == "ok" and len(r.tokens) == 4 for r in rep.results)
    assert rep.failed == rep.dropped == rep.unfinished == 0
    assert res.cfg.kv_quant is False               # the bf16 cache


def test_serve_main_returns_zero():
    assert serve.main(BASE) == 0


def test_serve_sim_backend(capsys):
    assert serve.main(BASE + ["--sim", "--decode-tokens", "0"]) == 0
    out = capsys.readouterr().out
    assert "[sim]" in out and "[engine]" not in out and "[decode]" not in out


def test_serve_unattainable_deadline_returns_one(capsys):
    args = [a if a != "60000" else "0.001" for a in BASE]
    res = serve.run(serve.parse_args(args))
    assert res.code == 1 and res.batch == 0
    assert "unattainable" in capsys.readouterr().out


UNPORTED = [("--arrival", "mmpp")]


def test_unported_flag_list_covers_the_table():
    assert {f for f, _ in UNPORTED} == {
        "--" + k.replace("_", "-") for k in serve.UNPORTED}


@pytest.mark.parametrize("flag,value", UNPORTED)
def test_unported_flag_returns_one(flag, value, capsys):
    extra = [flag] + ([value] if value is not None else [])
    assert serve.main(BASE + extra) == 1
    out = capsys.readouterr().out
    assert f"{flag}: not ported yet (ROADMAP queue 1, item" in out
    assert "[quant]" not in out                # refused before any work


def _served_as_reference(res):
    """Every request of a run ok, with the sequential batch-1 reference's
    tokens (bf16 cache): returns the run's outputs."""
    from repro_torch import engine as E
    assert res.code == 0
    rep = res.report
    assert all(r.status == "ok" for r in rep.results)
    assert sorted(r.rid for r in rep.results) == sorted(
        r.rid for r in res.requests)
    assert rep.outputs() == E.reference_outputs(
        res.cfg, res.params, res.requests, mode=res.mode,
        max_seq=res.engine.max_seq, device="cpu")
    return rep.outputs()


@pytest.fixture(scope="module")
def contiguous_run():
    """BASE with 8 requests sharing their first 4 prompt tokens, served
    from contiguous rows: what the paged runs are held to."""
    return serve.run(serve.parse_args(
        BASE + ["--n-requests", "8", "--shared-prefix-len", "4"]))


def test_serve_block_size_pages_the_bf16_cache(contiguous_run, capsys):
    """--block-size 4: the engine serves from the paged bf16 cache (every
    slot's full row in the default pool), with the reference's tokens and
    the contiguous run's, and prints its paged KV line."""
    res = serve.run(serve.parse_args(
        BASE + ["--n-requests", "8", "--shared-prefix-len", "4",
                "--block-size", "4"]))
    out = capsys.readouterr().out
    assert "[engine] paged KV:" in out and "0 leaked blocks" in out
    eng, rep = res.engine, res.report
    assert eng.block_size == 4 and rep.block_size == 4
    assert eng.num_blocks == eng.num_slots * eng.max_seq // 4 + 1
    assert res.engine._cache["k"].dtype == torch.bfloat16
    assert rep.leaked_blocks == 0
    assert _served_as_reference(res) == _served_as_reference(contiguous_run)


def test_serve_num_blocks_below_the_worst_case(contiguous_run):
    """--num-blocks 7 with blocks of 4: 6 usable blocks, against 4 slots x
    3 blocks a row, so admission waits for blocks; every request still
    gets the reference's tokens and the contiguous run's, and no block
    leaks."""
    res = serve.run(serve.parse_args(
        BASE + ["--n-requests", "8", "--shared-prefix-len", "4",
                "--block-size", "4", "--num-blocks", "7"]))
    rep = res.report
    assert rep.num_blocks == 7 and rep.peak_blocks_used <= 6
    assert rep.leaked_blocks == 0
    assert _served_as_reference(res) == _served_as_reference(contiguous_run)


def test_serve_shared_prefix_len_on_a_dense_arch(capsys):
    """--shared-prefix-len 4 on reduced qwen1.5-32b (RMSNorm, the gated
    SiLU MLP, an untied head, qkv bias), paged with blocks of 4: every
    request's prompt opens with the same 4 tokens, and the paged run's
    tokens equal the reference's and the contiguous run's of the same
    trace."""
    args = ["--arch", "qwen1.5-32b"] + BASE[2:] + [
        "--n-requests", "8", "--shared-prefix-len", "4"]
    contig = serve.run(serve.parse_args(args))
    paged = serve.run(serve.parse_args(args + ["--block-size", "4",
                                               "--num-blocks", "9"]))
    assert "[quant] qwen1.5-32b weights" in capsys.readouterr().out
    assert len({r.prompt[:4] for r in paged.requests}) == 1
    assert len({r.prompt for r in paged.requests}) == 8
    assert paged.report.leaked_blocks == 0
    assert _served_as_reference(paged) == _served_as_reference(contig)


@pytest.mark.parametrize("flags,message", [
    (["--shared-prefix-len", "6"], "--shared-prefix-len must be in"),
    (["--block-size", "3"], "config rejected: block_size must be a power"),
    (["--num-blocks", "9"], "config rejected: num_blocks needs block_size"),
])
def test_serve_paging_flags_refuse_bad_values(flags, message, capsys):
    assert serve.main(BASE + flags) == 1
    assert message in capsys.readouterr().out


OVERLOAD = ["--interactive-frac", "0.5", "--batch-quota", "1",
            "--preemption", "--fault-seed", "3", "--n-faults", "4"]


def test_serve_overload_flags(capsys):
    """The five overload flags through the CLI: two SLO classes by the
    rid hash, the batch quota, preemption and a seeded fault plan, with
    its retirement and faults lines; every request retires once, and
    every ok one equals the sequential reference (bf16 cache)."""
    from repro_torch import engine as E
    res = serve.run(serve.parse_args(BASE + ["--n-requests", "12"]
                                     + OVERLOAD))
    assert res.code == 0
    out = capsys.readouterr().out
    assert "[engine] retirement:" in out and "[engine] faults:" in out
    assert "interactive" in out and "batch" in out
    rep, reqs = res.report, res.requests
    assert {r.priority for r in reqs} == {"interactive", "batch"}
    assert res.engine.policy.class_quotas == {"batch": 1}
    assert res.fault_plan is not None and len(res.fault_plan) == 4
    assert sorted(r.rid for r in rep.results) == [r.rid for r in reqs]
    want = E.reference_outputs(res.cfg, res.params, reqs, mode=res.mode,
                               max_seq=res.engine.max_seq, device="cpu")
    assert all(r.tokens == want[r.rid] for r in rep.results
               if r.status == "ok")


@pytest.mark.parametrize("frac", ["1.5", "-0.1"])
def test_serve_interactive_frac_outside_unit_returns_one(frac, capsys):
    assert serve.main(BASE + ["--interactive-frac", frac]) == 1
    out = capsys.readouterr().out
    assert "--interactive-frac must be in [0, 1]" in out
    assert "[quant]" not in out                # refused before any work


def test_serve_needs_an_arch(capsys):
    assert serve.main(["--device", "cpu"]) == 1
    assert "need --arch" in capsys.readouterr().out


def test_serve_defaults_to_the_card():
    """Without --device the launcher runs on CUDA, and raises on a machine
    without a card instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "starcoder2-3b", "--reduced"])


@pytest.mark.parametrize("paging", [[], ["--block-size", "4"]],
                         ids=["contiguous", "paged"])
def test_serve_temperature_samples_as_the_reference(paging, capsys):
    """--temperature 0.8: the engine samples with PRNGKey(seed + 1) and
    the fold_in(rng, position) schedule: every request equals the sampled
    reference_outputs under that key (bf16 cache), and the run's tokens
    are not the greedy ones; the decode loop's tok/s stays greedy."""
    from repro_torch import engine as E
    from repro_torch.runtime.prng import PRNGKey
    res = serve.run(serve.parse_args(BASE + ["--n-requests", "8",
                                             "--temperature", "0.8"]
                                     + paging))
    assert res.code == 0
    assert "[decode]" in capsys.readouterr().out
    eng, rep = res.engine, res.report
    assert eng.temperature == 0.8
    assert torch.equal(eng.rng, PRNGKey(1))           # --seed 0, plus 1
    assert all(r.status == "ok" for r in rep.results)
    kw = dict(mode=res.mode, max_seq=eng.max_seq, device="cpu")
    want = E.reference_outputs(res.cfg, res.params, res.requests,
                               temperature=0.8, rng=PRNGKey(1), **kw)
    assert rep.outputs() == want
    assert want != E.reference_outputs(res.cfg, res.params, res.requests,
                                       **kw)
    if paging:
        assert rep.block_size == 4 and rep.leaked_blocks == 0


def test_service_curve_captures_one_graph_per_batch():
    """``jit_prefill_step`` under ``measure_service_curve``: one binding
    per measured batch, captured by the warm-up call, none more on a
    second curve; each batch's logits bitwise the eager forward's."""
    from repro_torch.configs import get_config
    from repro_torch.core.qlinear import W8A16
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST
    from repro_torch.runtime.graphs import MAX_BINDINGS

    assert len(serve.CURVE_BATCHES) + 1 <= MAX_BINDINGS
    cfg = get_config("starcoder2-3b").reduced()
    with torch.inference_mode():
        params = R.init_quantized(torch.Generator().manual_seed(0), cfg,
                                  min_size=2048, device="cpu")
    eager = ST.make_prefill_step(cfg, mode=W8A16)
    prefill = ST.jit_prefill_step(eager)
    for _ in range(2):
        _, curve = serve.measure_service_curve(prefill, params, cfg, seq=8,
                                               max_batch=4, device="cpu")
        assert sorted(curve) == [1, 4, 16]
        assert prefill.captured.captures == prefill.captured.bindings == 3
    g = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        for b in sorted(curve):
            batch = {"tokens": torch.randint(0, cfg.vocab, (b, 8),
                                             generator=g, dtype=torch.int32)}
            assert prefill.binding(params, batch) is not None
            assert torch.equal(prefill(params, batch), eager(params, batch))
    assert prefill.captured.captures == 3


@pytest.mark.parametrize("draft", [["--draft-layers", "1"],
                                   ["--draft", "starcoder2-3b"]],
                         ids=["draft-layers", "draft"])
def test_serve_spec_k_commits_the_non_speculative_stream(contiguous_run,
                                                         draft, capsys):
    """--spec-k 3 with a 1-layer self-draft, or with a cross-model draft
    (starcoder2-3b reduced, drawn from seed + 2): every request equals
    the non-speculative run's tokens and the sequential reference's, and
    the engine prints its speculative line."""
    res = serve.run(serve.parse_args(
        BASE + ["--n-requests", "8", "--shared-prefix-len", "4",
                "--spec-k", "3"] + draft))
    out = capsys.readouterr().out
    name = ("starcoder2-3b-reduced-draft1" if draft[0] == "--draft-layers"
            else "starcoder2-3b-reduced")
    assert f"[engine] speculative: k=3 ({name} draft)" in out
    assert "tokens committed per dispatch" in out
    assert res.report.spec_k == 3 and res.engine.dcfg.name == name
    assert res.report.accepted_per_dispatch >= 1.0
    assert _served_as_reference(res) == contiguous_run.report.outputs()
    if draft[0] == "--draft":
        # a checkpoint of its own, int8 like the target's
        assert res.engine.dparams["layers"][0] is not \
            res.params["layers"][0]


@pytest.mark.parametrize("flags", [
    ["--spec-k", "3"], ["--draft-layers", "1"],
    ["--spec-k", "3", "--draft-layers", "1", "--draft", "starcoder2-3b"],
    ["--spec-k", "3", "--draft-layers", "9"],
    ["--spec-k", "3", "--draft", "no-such-arch"]],
    ids=["no-draft", "no-spec-k", "two-drafts", "too-deep", "unknown"])
def test_serve_spec_k_refuses_a_bad_draft(flags, capsys):
    """--spec-k without a draft, a draft without --spec-k, both draft
    sources, a self-draft deeper than the model or a draft arch the
    registry does not know: the configuration is refused and the run
    exits 1."""
    assert serve.main(BASE + flags) == 1
    assert "[engine] config rejected:" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# multiplexing and the replica router
# ---------------------------------------------------------------------------

MODELS = ["--models", "starcoder2-3b,qwen2-moe-a2.7b"] + BASE[2:]


def test_serve_models_with_a_model_quota(capsys):
    """--models a,b --model-quota a=2: two lanes of one engine, each
    with its own sub-trace of --n-requests (rids offset by lane, weights
    from seed + lane), the quota never exceeded in a tick, one report line
    a model; each lane's tokens are its sequential reference's."""
    from repro_torch import engine as E
    res = serve.run(serve.parse_args(
        MODELS + ["--model-quota", "starcoder2-3b=2"]))
    assert res.code == 0
    out = capsys.readouterr().out
    tags = ("starcoder2-3b", "qwen2-moe-a2.7b")
    for tag in tags:
        assert f"[quant] {tag} weights" in out
        assert f"[engine]   model {tag}: p99" in out
    assert "(quota 2)" in out
    eng, rep = res.engine, res.report
    assert eng.multi and list(eng.lanes) == list(tags)
    assert sorted(r.rid for r in rep.results) == list(range(12))
    assert {r.model for r in rep.results if r.rid >= 6} == {tags[1]}
    assert all(r.status == "ok" for r in rep.results)
    assert max(rep.model_occupancy[tags[0]]) <= 2
    for tag, (cfg, params) in res.lanes.items():
        sub = [r for r in res.requests if r.model == tag]
        assert rep.outputs_for(tag) == E.reference_outputs(
            cfg, params, sub, mode=res.mode, max_seq=eng.max_seq,
            device="cpu")


def test_serve_replicas_prints_the_router_lines(capsys):
    """--replicas 2: the trace through a ReplicaRouter over two engines
    that share the weights; the fleet and per-replica lines, every
    request served, each as the sequential reference."""
    from repro_torch import engine as E
    res = serve.run(serve.parse_args(BASE + ["--n-requests", "8",
                                             "--replicas", "2"]))
    assert res.code == 0
    out = capsys.readouterr().out
    assert "[router] 2 replicas x" in out and "0 refused" in out
    assert "[router] per-replica occupancy: replica0=" in out
    assert "replica1=" in out and "[engine]" not in out
    rrep = res.router_report
    assert [e.name for e in res.fleet] == ["replica0", "replica1"]
    assert res.fleet[0].params is res.fleet[1].params
    assert sum(rrep.replica_requests.values()) == 8
    assert rrep.leaked_blocks == 0
    assert rrep.outputs() == E.reference_outputs(
        res.cfg, res.params, res.requests, mode=res.mode,
        max_seq=res.engine.max_seq, device="cpu")


ARCH = ["--arch", "starcoder2-3b"]


@pytest.mark.parametrize("flags,message", [
    (["--models", "starcoder2-3b,starcoder2-3b"],
     "--models tags must be unique"),
    (["--models", "starcoder2-3b", "--model-quota", "qwen2-moe-a2.7b=2"],
     "--model-quota names unknown lanes"),
    (ARCH + ["--model-quota", "starcoder2-3b=0"],
     "--model-quota wants TAG=N"),
    (ARCH + ["--model-quota", "starcoder2-3b"], "--model-quota wants TAG=N"),
    (ARCH + ["--replicas", "0"], "--replicas must be >= 1"),
    (ARCH + ["--replicas", "2", "--fault-seed", "3"],
     "--fault-seed wants a single engine"),
    (ARCH + ["--models", "starcoder2-3b,qwen2-moe-a2.7b"],
     "need --arch or --models"),
], ids=["duplicate-tags", "unknown-quota-lane", "quota-zero",
        "quota-no-count", "zero-replicas", "faults-with-replicas",
        "arch-and-models"])
def test_serve_multiplex_flags_refuse_bad_values(flags, message, capsys):
    """Each refusal exits 1 before any weight is drawn."""
    assert serve.main(flags + BASE[2:]) == 1
    out = capsys.readouterr().out
    assert message in out
    assert "[quant]" not in out


# -- --tp: the slot pool split into shards on --device -------------------

def test_serve_tp_equals_the_reference(capsys):
    """--tp 2: the engine serves through ShardedExecutor(2) on the CPU,
    its outputs the sequential reference's, with the reference's line."""
    res = serve.run(serve.parse_args(BASE + ["--tp", "2"]))
    out = capsys.readouterr().out
    assert "[serve] sharded executor: tp=2 on cpu" in out
    assert res.engine.backend.kind == "sharded"
    assert res.engine.backend.tp == 2
    _served_as_reference(res)


def test_serve_replicas_with_tp_equal_the_reference(capsys):
    """--replicas 2 --tp 2: each replica its own sharded engine; every
    routed request's tokens the sequential reference's."""
    from repro_torch import engine as E
    res = serve.run(serve.parse_args(BASE + ["--replicas", "2", "--tp",
                                             "2"]))
    assert res.code == 0
    assert "[router] 2 replicas x" in capsys.readouterr().out
    assert len(res.fleet) == 2 and all(
        e.backend.kind == "sharded" and e.backend.tp == 2 for e in res.fleet)
    rep = res.router_report
    assert all(r.status == "ok" for r in rep.results)
    assert rep.outputs() == E.reference_outputs(
        res.cfg, res.params, res.requests, mode=res.mode,
        max_seq=res.engine.max_seq, device="cpu")


def test_serve_models_with_tp(capsys):
    """--models with --tp 2: every lane of the engine serves through the
    shards, each request ok."""
    res = serve.run(serve.parse_args(
        ["--models", "starcoder2-3b,qwen2-moe-a2.7b", "--tp", "2"]
        + BASE[2:]))
    assert res.code == 0
    assert res.engine.backend.tp == 2 and len(res.engine.lanes) == 2
    assert all(r.status == "ok" for r in res.report.results)
    assert len(res.report.results) == 12


@pytest.mark.parametrize("tp,message", [
    ("0", "--replicas and --tp must be >= 1"),
    ("3", "config rejected: num_slots=4 must divide by tp=3"),
], ids=["zero", "does-not-divide"])
def test_serve_tp_refuses_bad_values(tp, message, capsys):
    """--tp 0 exits 1 before any work; a pool that does not divide into
    the shards exits 1 when the engine is built (the reference's
    refusals)."""
    assert serve.main(BASE + ["--tp", tp]) == 1
    out = capsys.readouterr().out
    assert message in out
    assert ("[quant]" in out) == (tp != "0")
