"""The port's multi-model multiplexing on the CPU at reduced size
(tests/test_multiplex.py's cases, and tests/test_dispatch.py's hot-swap
cases, on the port).

One ``Engine(models={...})`` serves interleaved two-model traces.  The
bar: every lane's outputs bit for bit those of a dedicated single-model
engine serving only that lane's requests, for every pair from {dense,
moe, encdec}, greedy and sampled, on paged pools tight enough to make
admission wait and with preemption of mixed SLO classes in the loop.
Against the JAX package's multiplexed engine, on one trace under the
virtual clock and the same bridged W8A16 weights: the same schedule
(status, slot, admission, first-token and finish times of every rid;
scheduling reads no token value, there being no end-of-sequence token),
the same faults fired at the same global slot ids, and greedy tokens
equal up to a near-tie of the JAX reference (ROADMAP section 3).

The differential cases draw the port's own weights
(``registry.init_quantized``); the JAX cases bridge the reference's
through ``models/bridge.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs import get_config as jget_config
from repro.core import batching as jbt
from repro.core.qlinear import W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import registry as JR
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core import batching as bt
from repro_torch.core.qlinear import W8A16
from repro_torch.engine import dispatch as D
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.runtime.prng import PRNGKey

from test_torch_engine import _jax_reference_with_margins
from test_torch_model import LOGIT_ATOL, to_numpy

SAMPLE_T = 0.8
SAMPLE_SEED = 5

# every family pair from {dense, moe, encdec}: (arch, weight seed)
FAMILIES = {"dense": ("starcoder2-3b", 0),
            "moe": ("qwen2-moe-a2.7b", 1),
            "encdec": ("whisper-medium", 2)}
PAIRS = [("dense", "moe"), ("dense", "encdec"), ("moe", "encdec")]

# one geometry for the module: 4 leased slots, each lane's paged pool 12
# usable blocks of 4 (three 16-token rows, below the 4 x 4 worst case)
MAX_SEQ = 16
ENGINE_KW = dict(mode=W8A16, device="cpu", num_slots=4, max_seq=MAX_SEQ,
                 prefill_chunk=4, block_size=4, num_blocks=13)
N_LANE = 24                  # requests a lane in the differential traces

# the JAX cross-checks: qwen2-moe keeps test_torch_moe.py's full-width
# router properties (16 experts, top-4: an int8 router)
MOE_QUIRKS = dict(n_experts=16, top_k=4, n_heads=16, n_kv_heads=16,
                  d_ff=64, capacity_factor=1.25)
N_JAX = 8                    # requests a lane in the JAX cross-checks


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def families():
    """{family: (cfg, the port's W8A16 params)}, int8 KV cache."""
    out = {}
    for fam, (arch, seed) in FAMILIES.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), kv_quant=True)
        out[fam] = (cfg, R.init_quantized(torch.Generator().manual_seed(seed),
                                          cfg, device="cpu"))
    return out


def _two_class(rid):
    return "interactive" if rid % 3 else "batch"


def _trace(pkg, tag, cfg, n, *, seed, rid_offset=0, shift=0.0):
    """One lane's sub-trace (``pkg`` is either package's engine module):
    model-tagged, two SLO classes, infinite deadlines, sources for a
    family that primes, rids offset so the merged trace keys uniquely."""
    reqs = pkg.synthetic_requests(
        n, rate_per_s=2000.0, vocab=cfg.vocab, prompt_len=4,
        max_new_tokens=5, seed=seed, model=tag, priority=_two_class,
        source_shape=((R.source_len(cfg), cfg.d_model)
                      if R.needs_prime(cfg) else None))
    return [dataclasses.replace(r, rid=r.rid + rid_offset,
                                arrival_s=r.arrival_s + shift)
            for r in reqs]


def _merged(families, fa, fb, n=N_LANE):
    ca, pa = families[fa]
    cb, pb = families[fb]
    merged = sorted(_trace(E, "a", ca, n, seed=11)
                    + _trace(E, "b", cb, n, seed=22, rid_offset=1000),
                    key=lambda r: r.arrival_s)
    return merged, {"a": (ca, pa), "b": (cb, pb)}


def _strip(reqs, tag):
    return [dataclasses.replace(r, model=None) for r in reqs
            if r.model == tag]


def _sampling(temperature):
    return dict(temperature=temperature,
                rng=PRNGKey(SAMPLE_SEED) if temperature else None)


# ---------------------------------------------------------------------------
# the differential harness: multiplexed == dedicated, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fa,fb", PAIRS)
@pytest.mark.parametrize("temperature", [0.0, SAMPLE_T],
                         ids=["greedy", "sampled"])
def test_multiplexed_matches_dedicated(families, fa, fb, temperature):
    """A 48-request interleaved two-model trace served multiplexed
    (paged, tight pools, preemption, two SLO classes): each lane's outputs
    equal a dedicated engine's on the lane's own sub-trace, bit for bit;
    the lanes' outputs partition the report's, and the lanes' occupancies
    sum to the engine's."""
    merged, lanes = _merged(families, fa, fb)
    kw = dict(ENGINE_KW, **_sampling(temperature))
    rep = E.Engine(models=lanes, **kw).serve(merged, preemption=True)
    assert len(rep.results) == len(merged)
    assert all(r.status == "ok" for r in rep.results)
    assert rep.leaked_blocks == 0 and rep.preempted > 0
    for tag, (cfg, params) in lanes.items():
        ded = E.Engine(cfg, params, **kw).serve(_strip(merged, tag),
                                                preemption=True)
        assert rep.outputs_for(tag) == ded.outputs(), tag
        assert all(r.model == tag for r in rep.results
                   if r.rid in ded.outputs())
    assert {**rep.outputs_for("a"), **rep.outputs_for("b")} == rep.outputs()
    assert set(rep.model_mean_occupancy) == {"a", "b"}
    assert sum(rep.model_mean_occupancy.values()) == \
        pytest.approx(rep.mean_occupancy, abs=1e-12)
    for t, occ in enumerate(rep.occupancy):
        assert occ == sum(v[t] for v in rep.model_occupancy.values())


def test_contiguous_lanes_match_dedicated(families):
    """The same on contiguous slot rows: each lane a dedicated engine's
    outputs, and its sequential batch-1 reference's."""
    merged, lanes = _merged(families, "dense", "moe", n=12)
    kw = dict(ENGINE_KW, block_size=None, num_blocks=None)
    rep = E.Engine(models=lanes, **kw).serve(merged)
    for tag, (cfg, params) in lanes.items():
        sub = _strip(merged, tag)
        assert rep.outputs_for(tag) == \
            E.Engine(cfg, params, **kw).serve(sub).outputs() == \
            E.reference_outputs(cfg, params, sub, mode=W8A16,
                                max_seq=MAX_SEQ, device="cpu")


def test_multiplexed_speculation_where_a_lane_can_draft(families):
    """``draft_layers=1`` on a dense and an encdec lane: the dense lane
    speculates, the encdec lane (no rewindable state for a draft) serves
    without; both lanes equal their dedicated non-speculative engines."""
    merged, lanes = _merged(families, "dense", "encdec", n=12)
    eng = E.Engine(models=lanes, spec_k=2, draft_layers=1, **ENGINE_KW)
    assert eng.lanes["a"].spec_k == 2 and eng.lanes["b"].spec_k == 0
    rep = eng.serve(merged)
    assert rep.accepted_per_dispatch > 1.0
    for tag, (cfg, params) in lanes.items():
        assert rep.outputs_for(tag) == E.Engine(
            cfg, params, **ENGINE_KW).serve(_strip(merged, tag)).outputs()


def test_prefix_keys_are_seeded_with_the_tag(families):
    """The same prompt gives a different key chain on each lane, and on
    neither the untagged chain of a single-model engine."""
    merged, lanes = _merged(families, "dense", "moe", n=4)
    eng = E.Engine(models=lanes, **ENGINE_KW)
    single = E.Engine(*lanes["a"], **ENGINE_KW)
    probe = _strip(merged, "a")[0]
    core, core0 = D.DispatchCore(eng), D.DispatchCore(single)
    ka = core._prefix_keys(eng.lanes["a"], probe)
    kb = core._prefix_keys(eng.lanes["b"], probe)
    k0 = core0._prefix_keys(single.lanes[None], probe)
    assert ka and kb and k0
    assert ka != kb and ka != k0 and kb != k0
    assert ka[0][0] == (("model", "a"), ())


# ---------------------------------------------------------------------------
# isolation: one lane's poison never reaches the other
# ---------------------------------------------------------------------------

class _PoisonedBackend(D.SingleDeviceExecutor):
    """The one-card step set, but every sample of ``cfg``'s slot step is
    the non-finite sentinel -1."""

    def __init__(self, cfg):
        self.cfg = cfg

    def slot_step(self, cfg, *, mode, temperature):
        step = super().slot_step(cfg, mode=mode, temperature=temperature)
        if cfg != self.cfg:
            return step

        def poisoned(*args):
            nxt, cache, index = step(*args)
            return torch.full_like(nxt, -1), cache, index
        return poisoned


def test_poisoned_lane_leaves_the_other_unchanged(families):
    """Every sample of lane a is the -1 sentinel: its requests exhaust
    their retries and retire ``failed``, and lane b's outputs are bitwise
    a clean run's."""
    merged, lanes = _merged(families, "dense", "moe", n=12)
    clean = E.Engine(models=lanes, **ENGINE_KW).serve(merged,
                                                      preemption=True)
    eng = E.Engine(models=lanes, backend=_PoisonedBackend(lanes["a"][0]),
                   **ENGINE_KW)
    rep = eng.serve(merged, preemption=True, max_retries=1)
    assert len(rep.results) == len(merged)
    assert all(r.status == "failed" for r in rep.results if r.model == "a")
    assert all(r.status == "ok" for r in rep.results if r.model == "b")
    assert rep.outputs_for("b") == clean.outputs_for("b")
    assert rep.leaked_blocks == 0


def test_nan_in_one_lanes_cache_never_reaches_the_other(families):
    """A lane's cache full of NaN: the other lane's next tick is bitwise
    unchanged — no tensor of one lane is an input to the other's step."""
    _, lanes = _merged(families, "dense", "moe", n=1)
    outs = []
    for poison in (False, True):
        eng = E.Engine(models=lanes, **ENGINE_KW)
        ln = eng.lanes["b"]
        S = eng.num_slots
        step = eng.backend.slot_step(ln.cfg, mode=W8A16, temperature=0.0)
        with torch.inference_mode():
            if poison:
                for t in eng.lanes["a"].zeroed_cache().values():
                    if t.is_floating_point():
                        t.fill_(float("nan"))
            nxt, _, idx = step(ln.params,
                               torch.ones((S, 1), dtype=torch.int32),
                               ln.zeroed_cache(),
                               torch.zeros((S,), dtype=torch.int32),
                               torch.ones((S,), dtype=torch.bool))
        outs.append((nxt.clone(), idx.clone()))
    assert all(torch.equal(x, y) for x, y in zip(*outs))


# ---------------------------------------------------------------------------
# quotas by model
# ---------------------------------------------------------------------------

def test_model_quota_caps_lane_occupancy(families):
    """``class_quotas={"a": 2}``: lane a never holds more than 2 of the 4
    leased slots in a tick, lane b takes the rest once a's short queue
    drains, and every request completes."""
    ca, pa = families["dense"]
    cb, pb = families["moe"]
    merged = sorted(_trace(E, "a", ca, 8, seed=11)
                    + _trace(E, "b", cb, 24, seed=22, rid_offset=1000),
                    key=lambda r: r.arrival_s)
    policy = bt.AdmissionPolicy(lambda b: 0.0, max_batch=4, max_wait_s=0.0,
                                class_quotas={"a": 2})
    eng = E.Engine(models={"a": (ca, pa), "b": (cb, pb)}, policy=policy,
                   **dict(ENGINE_KW, num_blocks=None))
    rep = eng.serve(merged)
    assert all(r.status == "ok" for r in rep.results)
    assert len(rep.results) == len(merged)
    assert max(rep.model_occupancy["a"]) <= 2
    assert max(rep.model_occupancy["b"]) > 2
    assert rep.leaked_blocks == 0


# ---------------------------------------------------------------------------
# against the JAX package's multiplexed engine
# ---------------------------------------------------------------------------

_JAX = {}


def _jax_lanes():
    """{tag: (jcfg, cfg, JAX W8A16 params, the port's bridged copy)}: a
    dense lane and an MoE lane with an int8 router, int8 KV caches."""
    if not _JAX:
        for tag, arch, quirks, seed in (("a", "starcoder2-3b", {}, 0),
                                        ("b", "qwen2-moe-a2.7b", MOE_QUIRKS,
                                         1)):
            jcfg, cfg = (dataclasses.replace(get(arch).reduced(),
                                             kv_quant=True, **quirks)
                         for get in (jget_config, get_config))
            jq = jquantize_tree(JR.init(jax.random.PRNGKey(seed), jcfg),
                                min_size=2048)
            _JAX[tag] = (jcfg, cfg, jq,
                         bridge.params_from_numpy(to_numpy(jq), device="cpu"))
    return _JAX


def _jax_pair(shift=0.0):
    """The two packages' merged traces (the same requests) and lanes."""
    lanes = _jax_lanes()
    out = []
    for pkg, pick in ((JE, 0), (E, 1)):
        reqs = []
        for tag, off, seed in (("a", 0, 11), ("b", 100, 22)):
            reqs += _trace(pkg, tag, lanes[tag][1], N_JAX, seed=seed,
                           rid_offset=off)
        out.append(sorted(reqs, key=lambda r: r.arrival_s))
    jlanes = {t: (v[0], v[2]) for t, v in lanes.items()}
    tlanes = {t: (v[1], v[3]) for t, v in lanes.items()}
    return out[0], out[1], jlanes, tlanes


def _schedule(rep):
    return [(r.rid, r.model, r.status, r.slot, r.admit_s, r.first_token_s,
             r.finish_s, r.preemptions) for r in rep.results]


def _tokens_agree(jreqs, got, want, lanes):
    """Each request's tokens equal the JAX engine's up to the first step
    where either parts from the JAX sequential reference, and that step
    is a near-tie of the reference (top-2 logit gap within LOGIT_ATOL)."""
    for tag, (jcfg, _, jq, _) in lanes.items():
        sub = [r for r in jreqs if r.model == tag]
        jref, gaps = _jax_reference_with_margins(jcfg, jq, sub, MAX_SEQ)
        for r in sub:
            a, b, ref = got[r.rid], want[r.rid], jref[r.rid]
            first = next((i for i, (x, y, z) in enumerate(zip(a, b, ref))
                          if not x == y == z), len(b))
            assert a[:first] == b[:first], r.rid
            if first < len(b):
                assert gaps[r.rid][first] <= LOGIT_ATOL, (r.rid, first)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_schedule_equals_the_jax_multiplexed_engine(paged):
    """Both packages' ``Engine(models=...)`` on one trace, virtual clock,
    preemption and a model quota: the same status, slot, admission,
    first-token and finish time of every rid, the same per-lane
    occupancy and counters; tokens as ``_tokens_agree`` says."""
    jreqs, reqs, jlanes, tlanes = _jax_pair()
    kw = dict(num_slots=4, max_seq=MAX_SEQ, prefill_chunk=4,
              block_size=4 if paged else None,
              num_blocks=9 if paged else None)
    quotas = {"b": 3, "batch": 2}
    jpol = jbt.AdmissionPolicy(lambda b: 0.0, max_batch=4, max_wait_s=0.0,
                               class_quotas=quotas)
    pol = bt.AdmissionPolicy(lambda b: 0.0, max_batch=4, max_wait_s=0.0,
                             class_quotas=quotas)
    jrep = JE.Engine(models=jlanes, mode=JW8A16, policy=jpol, **kw).serve(
        jreqs, preemption=True)
    rep = E.Engine(models=tlanes, mode=W8A16, device="cpu", policy=pol,
                   **kw).serve(reqs, preemption=True)
    assert _schedule(rep) == _schedule(jrep)
    assert rep.model_occupancy == jrep.model_occupancy
    for name in ("ticks", "preempted", "refused", "generated_tokens",
                 "peak_blocks_used", "leaked_blocks", "mean_occupancy",
                 "model_p99_latency_s", "model_mean_ttft_s",
                 "model_goodput_tokens_per_s"):
        assert getattr(rep, name) == getattr(jrep, name), name
    _tokens_agree(jreqs, rep.outputs(), jrep.outputs(), _jax_lanes())


def test_chaos_arm_fires_the_jax_faults_at_the_same_global_ids():
    """A seeded cross-lane ``FaultPlan`` (global ids over 2 lanes x 4
    slots) with preemption on tight pools: the same faults fire at the
    same global ids as on the JAX engine, with the same statuses, and
    every request the port completes equals its lane's batch-1
    reference."""
    from repro.engine import faults as JF

    jreqs, reqs, jlanes, tlanes = _jax_pair()
    kw = dict(num_slots=4, max_seq=MAX_SEQ, prefill_chunk=4, block_size=4,
              num_blocks=9)
    plan = E.FaultPlan.random(7, n_faults=10, max_tick=60, num_slots=8)
    jplan = JF.FaultPlan.random(7, n_faults=10, max_tick=60, num_slots=8)
    jrep = JE.Engine(models=jlanes, mode=JW8A16, **kw).serve(
        jreqs, preemption=True, fault_plan=jplan, max_retries=2)
    rep = E.Engine(models=tlanes, mode=W8A16, device="cpu", **kw).serve(
        reqs, preemption=True, fault_plan=plan, max_retries=2)
    assert plan.fired == jplan.fired
    assert {g // 4 for _, _, g in plan.fired} == {0, 1}   # both lanes hit
    assert {k for _, k, _ in plan.fired} == set(E.FAULT_KINDS)
    assert _schedule(rep) == _schedule(jrep)
    for name in ("failed", "dispatch_retries", "nonfinite_samples",
                 "torn_rows_repaired", "leaked_blocks"):
        assert getattr(rep, name) == getattr(jrep, name), name
    for tag, (cfg, params) in tlanes.items():
        want = E.reference_outputs(cfg, params, _strip(reqs, tag),
                                   mode=W8A16, max_seq=MAX_SEQ, device="cpu")
        for r in rep.results:
            if r.model == tag and r.status == "ok":
                assert r.tokens == want[r.rid], r.rid


# ---------------------------------------------------------------------------
# hot-swap on a live serve (tests/test_dispatch.py's cases)
# ---------------------------------------------------------------------------

def _hot_lanes(families):
    return {"a": families["dense"], "b": families["moe"]}


HOT_KW = dict(mode=W8A16, device="cpu", num_slots=4, max_seq=MAX_SEQ,
              prefill_chunk=2)


def test_retire_model_drains_inflight_and_refuses_late(families):
    """``retire_model`` mid-serve: the retiring lane's in-flight requests
    finish as they would have, its later arrivals come back ``refused``
    (no tokens, slot -1), the drained lane leaves the engine, and the
    other lane is undisturbed."""
    lanes = _hot_lanes(families)
    (ca, _), (cb, _) = lanes["a"], lanes["b"]
    ta = _trace(E, "a", ca, 12, seed=11)
    tb = _trace(E, "b", cb, 12, seed=22, rid_offset=100)
    late = _trace(E, "b", cb, 6, seed=33, rid_offset=200, shift=0.004)
    merged = sorted(ta + tb + late, key=lambda r: r.arrival_s)
    eng = E.Engine(models=lanes, **HOT_KW)
    rep = eng.serve(merged, control=[(0.004,
                                      lambda e: e.retire_model("b"))])
    assert len(rep.results) == len(merged)
    ok_b = [r for r in rep.results if r.model == "b" and r.status == "ok"]
    ref_b = [r for r in rep.results
             if r.model == "b" and r.status == "refused"]
    assert ok_b and ref_b and rep.refused == len(ref_b)
    assert all(r.tokens == [] and r.slot == -1 for r in ref_b)
    assert {r.rid for r in ref_b} >= {r.rid for r in late}
    assert "b" not in eng.lanes and "a" in eng.lanes
    base = E.Engine(models=lanes, **HOT_KW).serve(merged).outputs()
    assert all(base[r.rid] == r.tokens for r in ok_b)
    assert rep.outputs_for("a") == {r.rid: base[r.rid] for r in ta}


def test_admit_model_joins_a_live_serve(families):
    """``admit_model`` mid-serve: the new lane serves the requests that
    arrived for it, equal to a dedicated engine over the same sub-trace,
    and stays admitted."""
    ca, pa = families["dense"]
    cb, pb = families["moe"]
    ta = _trace(E, "a", ca, 12, seed=11)
    tc = _trace(E, "c", cb, 6, seed=44, rid_offset=300, shift=0.002)
    merged = sorted(ta + tc, key=lambda r: r.arrival_s)
    eng = E.Engine(models={"a": (ca, pa)}, **HOT_KW)
    rep = eng.serve(merged, control=[(0.002, lambda e: e.admit_model(
        "c", cb, pb))])
    okc = [r for r in rep.results if r.model == "c" and r.status == "ok"]
    assert len(okc) == len(tc) and "c" in eng.lanes
    assert eng.lanes["c"].order == 1 and eng.lanes["c"].epoch == 1
    want = E.Engine(cb, pb, **HOT_KW).serve(_strip(merged, "c")).outputs()
    assert rep.outputs_for("c") == want
    # a second serve on the swapped engine: both lanes, same outputs
    again = eng.serve(merged)
    assert again.outputs_for("c") == want
    assert again.outputs_for("a") == rep.outputs_for("a")


def test_admit_after_retire_takes_a_fresh_order(families):
    """A lane admitted after another was retired and removed takes an
    order above every lane's, so no two lanes share global fault ids."""
    lanes = _hot_lanes(families)
    eng = E.Engine(models=lanes, **HOT_KW)
    eng.retire_model("a")
    eng.serve([])
    assert list(eng.lanes) == ["b"]
    eng.admit_model("c", *families["dense"])
    assert [ln.order for ln in eng.lanes.values()] == [1, 2]


def test_admit_model_rejects_duplicates_and_single_model(families):
    ca, pa = families["dense"]
    cb, pb = families["moe"]
    eng = E.Engine(models={"a": (ca, pa)}, **HOT_KW)
    with pytest.raises(ValueError, match="already"):
        eng.admit_model("a", ca, pa)
    with pytest.raises(ValueError, match="non-empty string"):
        eng.admit_model("", cb, pb)
    with pytest.raises(ValueError, match="not admitted"):
        eng.retire_model("zzz")
    single = E.Engine(ca, pa, **HOT_KW)
    with pytest.raises(ValueError, match="multiplexed"):
        single.admit_model("b", cb, pb)


def test_per_lane_tick_cost_prices_dispatched_lanes(families):
    """A Mapping ``tick_s`` prices each tick as the sum of the lanes it
    dispatched: outputs are untouched, and the dearer lane stretches the
    clock."""
    lanes = _hot_lanes(families)
    merged = sorted(_trace(E, "a", lanes["a"][0], 12, seed=11)
                    + _trace(E, "b", lanes["b"][0], 12, seed=22,
                             rid_offset=100), key=lambda r: r.arrival_s)
    priced = E.Engine(models=lanes, **HOT_KW).serve(
        merged, tick_s={"a": 1e-3, "b": 5e-3})
    flat = E.Engine(models=lanes, **HOT_KW).serve(merged, tick_s=1e-3)
    assert priced.outputs() == flat.outputs()
    assert priced.duration_s > flat.duration_s


@pytest.mark.parametrize("clock,tick_s,match", [
    ("wall", {"a": 1e-3, "b": 1e-3}, "virtual"),
    ("virtual", {"a": 1e-3}, "every lane"),
])
def test_per_lane_tick_cost_validation(families, clock, tick_s, match):
    lanes = _hot_lanes(families)
    eng = E.Engine(models=lanes, **HOT_KW)
    reqs = _trace(E, "a", lanes["a"][0], 2, seed=1)
    with pytest.raises(ValueError, match=match):
        eng.serve(reqs, clock=clock, tick_s=tick_s)


# ---------------------------------------------------------------------------
# validation of the multi-model surface (tests/test_multiplex.py:454-485)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,match", [
    ("unknown_tag", "not admitted"),
    ("tagged_on_single", "not admitted"),
    ("both", "exactly one"),
    ("neither", "exactly one"),
    ("empty", "at least one"),
    ("empty_tag", "non-empty string"),
    ("explicit_draft", "draft_layers"),
    ("spec_without_layers", "draft_layers"),
    ("control_not_callable", "callable"),
])
def test_constructor_and_serve_refusals(families, case, match):
    cfg, params = families["dense"]
    lanes = {"a": (cfg, params)}
    req = E.EngineRequest(rid=0, prompt=(1, 2), max_new_tokens=2, model="a")
    kw = dict(mode=W8A16, device="cpu", num_slots=4, max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match=match):
        if case == "unknown_tag":
            E.Engine(models=lanes, **kw).serve(
                [dataclasses.replace(req, model="zzz")])
        elif case == "tagged_on_single":
            E.Engine(cfg, params, **kw).serve([req])
        elif case == "both":
            E.Engine(cfg, params, models=lanes, **kw)
        elif case == "neither":
            E.Engine(**kw)
        elif case == "empty":
            E.Engine(models={}, **kw)
        elif case == "empty_tag":
            E.Engine(models={"": (cfg, params)}, **kw)
        elif case == "explicit_draft":
            E.Engine(models=lanes, spec_k=2, draft=(cfg, params), **kw)
        elif case == "spec_without_layers":
            E.Engine(models=lanes, spec_k=2, **kw)
        else:
            E.Engine(models=lanes, **kw).serve([req], control=[(0.0, 1)])


def test_paging_refused_for_a_lane_that_cannot_page(families):
    """``block_size`` with a lane whose family keeps no positional cache
    is refused, naming the lane."""
    cfg, params = families["dense"]
    scfg = get_config("mamba2-1.3b").reduced()
    sparams = R.init_quantized(torch.Generator().manual_seed(3), scfg,
                               device="cpu")
    with pytest.raises(ValueError, match="model 's'"):
        E.Engine(models={"a": (cfg, params), "s": (scfg, sparams)},
                 **ENGINE_KW)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", [None, "a", "callable"])
def test_synthetic_requests_model_is_the_references(model):
    """``synthetic_requests(..., model=...)`` is byte for byte the JAX
    package's, for no tag, one tag and a ``rid -> tag`` callable."""
    tag = (lambda rid: "a" if rid % 2 else "b") if model == "callable" \
        else model
    kw = dict(rate_per_s=700.0, vocab=97, prompt_len=5, max_new_tokens=3,
              seed=4, shared_prefix_len=2, priority=_two_class, model=tag)
    mine, ref = E.synthetic_requests(9, **kw), JE.synthetic_requests(9, **kw)
    assert [(r.rid, r.prompt, r.max_new_tokens, r.arrival_s, r.deadline_s,
             r.priority, r.model) for r in mine] == \
        [(r.rid, r.prompt, r.max_new_tokens, r.arrival_s, r.deadline_s,
          r.priority, r.model) for r in ref]
    assert np.array_equal([r.arrival_s for r in mine],
                          [r.arrival_s for r in ref])
