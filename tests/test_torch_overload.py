"""The port's overload paths on the CPU at reduced size: SLO-class
admission with per-class quotas that count the slots a class holds,
preemption with exact resume, fault injection and recovery, and the typed
retirement statuses (tests/test_robustness.py's cases, on the port).

The bar is the engine's usual one: bit for bit its own sequential
reference, now through evictions, re-admissions and injected faults; and,
on one trace under one ``FaultPlan``, the JAX engine's tokens, statuses,
preemptions and fired faults.  The reduced starcoder2-3b has W8A16 weights
bridged from the JAX package's init and an int8 KV cache.  Sampled
decoding keeps the bar through resumes and faults: its keys are
``fold_in(rng, position)``, a function of the position alone."""
import dataclasses
import warnings

import jax
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # offline: no network, no pip
    from _hypothesis_compat import given, settings, strategies as st

from repro import engine as JE
from repro.configs import get_config as jget_config
from repro.core import batching as jbt
from repro.core.qlinear import W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.engine import faults as JF
from repro.models import registry as JR
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core import batching as bt
from repro_torch.core.qlinear import W8A16
from repro_torch.engine.faults import FAULT_KINDS, Fault, FaultPlan
from repro_torch.models import bridge
from repro_torch.runtime.prng import PRNGKey

from test_torch_model import to_numpy

MAX_SEQ = 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    jcfg = dataclasses.replace(jget_config("starcoder2-3b").reduced(),
                               kv_quant=True)
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    return jcfg, cfg


_SETUP = {}


def _setup():
    """(jcfg, cfg, JAX W8A16 params, the port's bridged copy), built once
    (the hypothesis shim's @given cannot consume pytest fixtures)."""
    if not _SETUP:
        jcfg, cfg = _cfgs()
        jq = jquantize_tree(JR.init(jax.random.PRNGKey(0), jcfg),
                            min_size=2048)
        params = bridge.params_from_numpy(to_numpy(jq), device="cpu")
        _SETUP["s"] = (jcfg, cfg, jq, params)
    return _SETUP["s"]


@pytest.fixture(scope="module")
def dense_setup():
    _, cfg, _, params = _setup()
    return cfg, params


def _two_class(rid):
    return "batch" if rid % 3 == 0 else "interactive"


@pytest.fixture(scope="module")
def trace(dense_setup):
    """A short two-class trace plus its sequential reference outputs."""
    cfg, params = dense_setup
    reqs = E.synthetic_requests(
        10, rate_per_s=2000.0, vocab=cfg.vocab, prompt_len=3,
        max_new_tokens=5, priority=_two_class)
    want = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                               max_seq=MAX_SEQ, device="cpu")
    return reqs, want


def _engine(cfg, params, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("prefill_chunk", 2)
    return E.Engine(cfg, params, mode=W8A16, max_seq=MAX_SEQ, device="cpu",
                    **kw)


def _held_at_once(results, cls):
    """The most slots ``cls`` held at once, from admit and finish times
    (a slot freed at a tick is reused the same tick: finishes first)."""
    events = []
    for r in results:
        if r.priority == cls and r.slot >= 0:
            events += [(r.admit_s, 1), (r.finish_s, -1)]
    held = most = 0
    for _, d in sorted(events):
        held += d
        most = max(most, held)
    return most


# ---------------------------------------------------------------------------
# SLO-class admission
# ---------------------------------------------------------------------------

class TestClassAdmission:
    def test_scheduler_orders_class_first(self):
        def req(rid, deadline, cls):
            return E.EngineRequest(rid=rid, prompt=(1,), max_new_tokens=1,
                                   arrival_s=0.0, deadline_s=deadline,
                                   priority=cls)

        sched = E.SlotScheduler(bt.AdmissionPolicy(lambda b: 0.0,
                                                   max_batch=8))
        sched.push(req(0, 5.0, "batch"))
        sched.push(req(1, 9.0, "interactive"))
        sched.push(req(2, 1.0, "batch"))
        sched.push(req(3, 2.0, "interactive"))
        # interactive (rank 0) ahead of batch, deadline order within class
        assert [r.rid for r in sched.pending] == [3, 1, 2, 0]

    def test_quota_skips_over_blocked_class(self):
        policy = bt.AdmissionPolicy(lambda b: 0.0, max_batch=4,
                                    max_wait_s=0.0,
                                    class_quotas={"batch": 1})
        act = policy.decide(0.0, [1.0, 2.0, 3.0], capacity=3,
                            classes=["batch", "batch", "interactive"],
                            active_by_class={"batch": 1})
        # batch quota already consumed by an active slot: both pending
        # batch requests are skipped, the later interactive one admits
        assert act.launch and act.picks == (2,)

    def test_no_quota_no_classes_is_legacy_path(self):
        policy = bt.AdmissionPolicy(lambda b: 0.0, max_batch=4,
                                    max_wait_s=0.0)
        act = policy.decide(0.0, [1.0, 2.0], capacity=4)
        assert act.launch and act.batch == 2 and act.picks is None

    def test_unknown_class_ranks_last(self):
        assert bt.priority_rank("interactive") == 0
        assert bt.priority_rank("batch") == 1
        assert bt.priority_rank("mystery") == len(bt.PRIORITY_CLASSES)

    def test_quota_serve_parity(self, dense_setup, trace):
        """Quota-constrained admission reorders *when* requests run, but
        never what they produce."""
        cfg, params = dense_setup
        reqs, want = trace
        policy = bt.AdmissionPolicy(lambda b: 0.0, max_batch=4,
                                    max_wait_s=0.0,
                                    class_quotas={"batch": 1})
        rep = _engine(cfg, params, policy=policy).serve(reqs)
        assert rep.outputs() == want
        assert all(r.status == "ok" for r in rep.results)

    @pytest.mark.parametrize("quota", [1, 2])
    @pytest.mark.parametrize("block_size", [None, 4])
    def test_quota_counts_held_slots(self, dense_setup, trace, quota,
                                     block_size):
        """The quota meters the slots a class already holds, not only the
        cohort being admitted: on the two-class trace through 4 slots the
        batch class never holds more than its quota at once (without the
        held count it took 3), and it does reach the quota."""
        cfg, params = dense_setup
        reqs, want = trace
        policy = bt.AdmissionPolicy(lambda b: 0.0, max_batch=4,
                                    max_wait_s=0.0,
                                    class_quotas={"batch": quota})
        rep = _engine(cfg, params, policy=policy,
                      block_size=block_size).serve(reqs)
        assert _held_at_once(rep.results, "batch") == quota
        assert max(rep.class_occupancy["batch"]) == quota
        assert rep.outputs() == want

    def test_quota_holds_under_preemption(self, dense_setup, trace):
        """With preemption on, a slot-starved pool evicts batch slots and
        readmits them: the batch class still never holds more than its
        quota in any tick (the per-tick class occupancy; an evicted
        request's admit-to-finish span also covers its time queued)."""
        cfg, params = dense_setup
        reqs, want = trace
        policy = bt.AdmissionPolicy(lambda b: 0.0, max_batch=2,
                                    max_wait_s=0.0,
                                    class_quotas={"batch": 1})
        rep = _engine(cfg, params, num_slots=2, policy=policy).serve(
            reqs, preemption=True)
        assert rep.preempted > 0
        occ = rep.class_occupancy
        assert len(occ["batch"]) == len(occ["interactive"]) == rep.ticks
        assert max(occ["batch"]) == 1
        assert [a + b for a, b in zip(occ["batch"], occ["interactive"])] \
            == rep.occupancy
        assert rep.outputs() == want

    def test_without_quota_the_batch_class_takes_more(self, dense_setup,
                                                      trace):
        """The same trace with no quota: the batch class holds more than
        one slot at once, so the quota test above has something to cap."""
        cfg, params = dense_setup
        reqs, _ = trace
        rep = _engine(cfg, params).serve(reqs)
        assert _held_at_once(rep.results, "batch") > 1


# ---------------------------------------------------------------------------
# preemption with exact resume
# ---------------------------------------------------------------------------

class TestPreemption:
    def test_block_pressure_preempts_and_resumes_exactly(
            self, dense_setup, trace):
        """A pool too small for the worst-case concurrent claim forces
        evictions; every resumed request is bit for bit its
        never-preempted self and the pool drains clean."""
        cfg, params = dense_setup
        reqs, want = trace
        eng = _engine(cfg, params, block_size=4, num_blocks=9)
        rep = eng.serve(reqs, preemption=True)
        assert rep.outputs() == want
        assert rep.preempted > 0
        assert rep.leaked_blocks == 0
        assert any(r.preemptions > 0 for r in rep.results)
        assert rep.resumed_prefill_tokens > 0

    def test_slot_pressure_preempts_and_resumes_exactly(
            self, dense_setup, trace):
        """Contiguous slots under a two-slot pool: interactive heads evict
        batch slots, and every request still equals the reference."""
        cfg, params = dense_setup
        reqs, want = trace
        rep = _engine(cfg, params, num_slots=2).serve(reqs, preemption=True)
        assert rep.outputs() == want
        assert rep.preempted > 0
        victims = [r for r in rep.results if r.preemptions]
        assert victims and all(r.priority == "batch" for r in victims)

    @pytest.mark.parametrize("pressure", ["blocks", "slots"])
    def test_sampled_resume_parity(self, dense_setup, pressure):
        """Position-derived sampling keys make resume exact for sampled
        decoding too, not just greedy: under block pressure (paged, 8
        usable blocks) or slot pressure (two contiguous slots), on the
        two-class trace the greedy preemption tests serve."""
        cfg, params = dense_setup
        rng = PRNGKey(7)
        reqs = E.synthetic_requests(
            10, rate_per_s=2000.0, vocab=cfg.vocab, prompt_len=3,
            max_new_tokens=5, priority=_two_class)
        want = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                                   max_seq=MAX_SEQ, device="cpu",
                                   temperature=0.8, rng=rng)
        kw = ({"block_size": 4, "num_blocks": 9} if pressure == "blocks"
              else {"num_slots": 2})
        eng = _engine(cfg, params, temperature=0.8, rng=rng, **kw)
        rep = eng.serve(reqs, preemption=True)
        assert rep.outputs() == want
        assert rep.preempted > 0 and rep.leaked_blocks == 0

    def test_uniform_class_never_preempts(self, dense_setup):
        """Preemption only evicts a *strictly* lower class than the
        waiting head: a single-class trace can never preempt, with the
        flag on and resources ample."""
        cfg, params = dense_setup
        reqs = E.synthetic_requests(10, rate_per_s=2000.0,
                                    vocab=cfg.vocab, prompt_len=3,
                                    max_new_tokens=5)
        want = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                                   max_seq=MAX_SEQ, device="cpu")
        rep = _engine(cfg, params, block_size=4).serve(reqs,
                                                       preemption=True)
        assert rep.outputs() == want
        assert rep.preempted == 0 and rep.leaked_blocks == 0

    def test_expired_preempted_request_keeps_its_tokens(self, dense_setup):
        """A preempted request whose deadline passes while it waits is
        dropped from the queue with the tokens it had generated, a
        prefix of its reference output, and its admission time."""
        cfg, params = dense_setup
        reqs = E.synthetic_requests(
            10, rate_per_s=2000.0, vocab=cfg.vocab, prompt_len=3,
            max_new_tokens=5, priority=_two_class)
        reqs = [dataclasses.replace(r, deadline_s=r.arrival_s + (
            0.012 if r.priority == "batch" else 1.0)) for r in reqs]
        want = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                                   max_seq=MAX_SEQ, device="cpu")
        rep = _engine(cfg, params, num_slots=2).serve(
            reqs, preemption=True, drop_missed_deadlines=True)
        assert sorted(r.rid for r in rep.results) == [r.rid for r in reqs]
        queued = [r for r in rep.results if r.slot < 0 and r.preemptions]
        assert queued, "no preempted request expired in the queue"
        for r in queued:
            assert r.status == "dropped" and r.tokens
            assert r.tokens == want[r.rid][:len(r.tokens)]
            assert 0 <= r.admit_s <= r.finish_s


# ---------------------------------------------------------------------------
# fault injection + recovery
# ---------------------------------------------------------------------------

class TestFaultInjection:
    def test_plan_is_deterministic_and_validated(self):
        a = FaultPlan.random(3, n_faults=6, num_slots=4)
        b = FaultPlan.random(3, n_faults=6, num_slots=4)
        assert a.faults == b.faults
        assert all(f.kind in FAULT_KINDS for f in a.faults)
        with pytest.raises(ValueError):
            Fault(tick=1, kind="meteor")
        with pytest.raises(ValueError):
            Fault(tick=-1, kind="dispatch")

    @pytest.mark.parametrize("seed", [0, 3, 5, 11])
    def test_plan_equals_the_jax_packages(self, seed):
        """One seed gives the JAX package's plan, and the same consulting
        sequence fires the same faults."""
        mine = FaultPlan.random(seed, n_faults=8, max_tick=60, num_slots=4)
        ref = JF.FaultPlan.random(seed, n_faults=8, max_tick=60,
                                  num_slots=4)
        assert [dataclasses.astuple(f) for f in mine.faults] == \
            [dataclasses.astuple(f) for f in ref.faults]
        assert E.FAULT_KINDS == JF.FAULT_KINDS
        for plan in (mine, ref):
            for tick in range(60):
                active = [s for s in range(4) if (s + tick) % 3]
                plan.torn_rows(tick, active)
                for attempt in range(3):
                    if plan.dispatch_fault(tick, attempt, active) is None:
                        break
                plan.nonfinite_slots(tick, active)
        assert mine.fired == ref.fired

    def test_transient_dispatch_fault_retries_to_parity(
            self, dense_setup, trace):
        cfg, params = dense_setup
        reqs, want = trace
        plan = FaultPlan([Fault(tick=4, kind="dispatch", slot=0,
                                repeat=2)])
        rep = _engine(cfg, params).serve(reqs, preemption=True,
                                         fault_plan=plan)
        assert rep.outputs() == want
        assert rep.dispatch_retries == 2 and rep.failed == 0

    def test_persistent_dispatch_fault_fails_only_the_culprit(
            self, dense_setup, trace):
        cfg, params = dense_setup
        reqs, want = trace
        plan = FaultPlan([Fault(tick=4, kind="dispatch", slot=1,
                                repeat=99)])
        rep = _engine(cfg, params).serve(reqs, preemption=True,
                                         fault_plan=plan, max_retries=2)
        failed = [r for r in rep.results if r.status == "failed"]
        assert len(failed) == 1 and rep.failed == 1
        assert rep.dispatch_retries == 3
        ok = {r.rid: r.tokens for r in rep.results if r.status == "ok"}
        assert len(ok) == len(reqs) - 1
        assert all(ok[rid] == want[rid] for rid in ok)

    def test_nan_logits_recover_bitwise(self, dense_setup, trace):
        """A transient non-finite sample preempts the victim; the resume
        recomputes clean state and the output heals bit for bit."""
        cfg, params = dense_setup
        reqs, want = trace
        plan = FaultPlan([Fault(tick=5, kind="nan_logits", slot=2)])
        rep = _engine(cfg, params).serve(reqs, preemption=True,
                                         fault_plan=plan)
        assert rep.outputs() == want
        assert rep.nonfinite_samples >= 1 and rep.failed == 0
        assert plan.fired == [(5, "nan_logits", 2)]

    @pytest.mark.parametrize("block_size", [None, 4])
    def test_real_nonfinite_cache_row_heals(self, dense_setup, trace,
                                            block_size):
        """A NaN written into a generating slot's cache (its position-0
        key scales, every layer) makes the step's finite guard emit its
        sentinel: the slot is rebuilt from ``prompt + generated`` and
        the request's output is bit for bit the reference, with no
        FaultPlan and no preemption flag (recovery is always on)."""
        cfg, params = dense_setup
        reqs, want = trace
        eng = _engine(cfg, params, block_size=block_size)
        inner = eng.backend.slot_step(cfg, mode=W8A16, temperature=0.0)
        calls = []

        def poisoned(params, tokens, cache, index, active):
            calls.append(1)
            if len(calls) == 6:
                sid = int(torch.nonzero(active)[0])
                pos = 0
                if "block_tables" in cache:
                    pos = int(cache["block_tables"][sid, 0])
                    cache["k_scale"][:, pos, 0] = float("nan")
                else:
                    cache["k_scale"][:, sid, pos] = float("nan")
            return inner(params, tokens, cache, index, active)

        eng.backend.slot_step = lambda *a, **k: poisoned
        rep = eng.serve(reqs)
        assert rep.nonfinite_samples == 1
        assert rep.failed == 0 and rep.preempted == 1
        assert rep.outputs() == want
        assert all(r.status == "ok" for r in rep.results)

    def test_nonfinite_past_max_retries_fails(self, dense_setup, trace):
        """A slot whose samples keep going non-finite exhausts its retry
        budget and retires as failed; the others are untouched."""
        cfg, params = dense_setup
        reqs, want = trace
        plan = FaultPlan([Fault(tick=t, kind="nan_logits", slot=0)
                          for t in range(4, 40)])
        rep = _engine(cfg, params).serve(reqs, fault_plan=plan,
                                         max_retries=1)
        assert rep.failed >= 1
        assert rep.nonfinite_samples >= 2
        for r in rep.results:
            if r.status == "ok":
                assert r.tokens == want[r.rid]
            else:
                assert r.status == "failed"

    def test_torn_table_row_repaired_from_host_mirror(
            self, dense_setup, trace):
        cfg, params = dense_setup
        reqs, want = trace
        plan = FaultPlan([Fault(tick=5, kind="torn_table", slot=0)])
        rep = _engine(cfg, params, block_size=4).serve(
            reqs, preemption=True, fault_plan=plan)
        assert rep.outputs() == want
        assert rep.torn_rows_repaired >= 1
        assert rep.leaked_blocks == 0

    @pytest.mark.parametrize("block_size", [None, 4])
    def test_sampled_faults_recover_bitwise(self, dense_setup, block_size):
        """A sampled engine under a transient dispatch fault, a non-finite
        sample and (paged) a torn table row: every request equals the
        sampled reference, nothing leaks."""
        cfg, params = dense_setup
        rng = PRNGKey(3)
        reqs = E.synthetic_requests(
            10, rate_per_s=2000.0, vocab=cfg.vocab, prompt_len=3,
            max_new_tokens=5, priority=_two_class)
        want = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                                   max_seq=MAX_SEQ, device="cpu",
                                   temperature=0.8, rng=rng)
        faults = [Fault(tick=4, kind="dispatch", slot=0, repeat=2),
                  Fault(tick=6, kind="nan_logits", slot=1)]
        if block_size:
            faults.append(Fault(tick=8, kind="torn_table", slot=2))
        plan = FaultPlan(faults)
        eng = _engine(cfg, params, block_size=block_size, temperature=0.8,
                      rng=rng)
        rep = eng.serve(reqs, preemption=True, fault_plan=plan)
        assert len(plan.fired) == sum(f.repeat for f in faults)
        assert rep.outputs() == want
        assert rep.failed == 0 and rep.leaked_blocks == 0
        assert rep.nonfinite_samples >= 1

    def test_torn_row_leaves_the_binding_alone(self, dense_setup, trace):
        """The tear is written into the cache's block-table tensor in
        place: the warmed-up tick keeps its one binding (no capture inside
        the serve) and the cache keeps its tensors."""
        cfg, params = dense_setup
        reqs, want = trace
        eng = _engine(cfg, params, block_size=4)
        eng.warmup()
        cache = eng.zeroed_cache()
        leaves = {k: v for k, v in cache.items()}
        step = eng.backend.slot_step(cfg, mode=W8A16, temperature=0.0)
        S = eng.num_slots
        args = (torch.zeros((S, 1), dtype=torch.int32), cache,
                torch.zeros((S,), dtype=torch.int32),
                torch.zeros((S,), dtype=torch.bool))
        before = step.binding(params, *args)
        captures = step.captured.captures
        assert before is not None
        plan = FaultPlan([Fault(tick=5, kind="torn_table", slot=0),
                          Fault(tick=9, kind="torn_table", slot=1)])
        rep = eng.serve(reqs, preemption=True, fault_plan=plan)
        assert rep.torn_rows_repaired == 2
        assert rep.outputs() == want
        assert step.captured.captures == captures
        assert step.binding(params, *args) is before
        assert all(eng._cache[k] is v for k, v in leaves.items())


# ---------------------------------------------------------------------------
# the port against the JAX engine, one trace, one FaultPlan
# ---------------------------------------------------------------------------

JAX_PARITY_PLANS = {
    "fixed": [("dispatch", 4, 1, 2), ("nan_logits", 7, 2, 1),
              ("torn_table", 9, 0, 1), ("dispatch", 12, 3, 99)],
    "random": 7,
}


@pytest.mark.parametrize("block_size", [None, 4])
@pytest.mark.parametrize("plan_kind", list(JAX_PARITY_PLANS))
def test_overload_serve_equals_jax_engine(trace, block_size, plan_kind):
    """The port's engine and the JAX engine, same bridged W8A16 weights,
    int8 cache, same two-class trace through a pool of 4 slots (paged: 8
    usable blocks) with preemption on and one FaultPlan: equal tokens,
    statuses, preemptions per request, counters and fired faults; and
    every ok request equals the port's own reference."""
    jcfg, cfg, jq, params = _setup()
    reqs, want = trace
    jreqs = JE.synthetic_requests(
        10, rate_per_s=2000.0, vocab=cfg.vocab, prompt_len=3,
        max_new_tokens=5, priority=_two_class)
    spec = JAX_PARITY_PLANS[plan_kind]
    if isinstance(spec, int):
        plan = FaultPlan.random(spec, n_faults=6, max_tick=40, num_slots=4)
        jplan = JF.FaultPlan.random(spec, n_faults=6, max_tick=40,
                                    num_slots=4)
    else:
        plan = FaultPlan([Fault(t, k, s, r) for k, t, s, r in spec])
        jplan = JF.FaultPlan([JF.Fault(t, k, s, r) for k, t, s, r in spec])
    kw = dict(num_slots=4, max_seq=MAX_SEQ, prefill_chunk=2,
              block_size=block_size,
              num_blocks=9 if block_size else None)
    jrep = JE.Engine(jcfg, jq, mode=JW8A16, **kw).serve(
        jreqs, preemption=True, fault_plan=jplan, max_retries=2)
    rep = E.Engine(cfg, params, mode=W8A16, device="cpu", **kw).serve(
        reqs, preemption=True, fault_plan=plan, max_retries=2)
    assert rep.outputs() == jrep.outputs()
    assert [(r.rid, r.status, r.preemptions, r.slot)
            for r in rep.results] == \
        [(r.rid, r.status, r.preemptions, r.slot) for r in jrep.results]
    for name in ("ticks", "preempted", "failed", "dispatch_retries",
                 "nonfinite_samples", "torn_rows_repaired",
                 "leaked_blocks", "generated_tokens"):
        assert getattr(rep, name) == getattr(jrep, name), name
    assert plan.fired == jplan.fired and plan.fired
    for r in rep.results:
        if r.status == "ok":
            assert r.tokens == want[r.rid]


# ---------------------------------------------------------------------------
# typed retirement statuses + scheduler guards
# ---------------------------------------------------------------------------

class TestTypedStatuses:
    def test_tick_cap_retires_unfinished_with_warning(
            self, dense_setup, trace):
        cfg, params = dense_setup
        reqs, _ = trace
        eng = _engine(cfg, params, num_slots=2, prefill_chunk=None)
        with pytest.warns(RuntimeWarning, match="tick cap"):
            rep = eng.serve(reqs, max_ticks=6)
        # nothing lost, nothing silently reported as served
        assert len(rep.results) == len(reqs)
        assert rep.unfinished > 0
        assert {r.status for r in rep.results} <= {"ok", "unfinished"}
        assert sum(r.status == "unfinished" for r in rep.results) == \
            rep.unfinished

    def test_every_request_retires_exactly_once(self, dense_setup, trace):
        cfg, params = dense_setup
        reqs, _ = trace
        plan = FaultPlan.random(5, n_faults=6, max_tick=60, num_slots=4)
        eng = _engine(cfg, params, block_size=4, num_blocks=9)
        rep = eng.serve(reqs, preemption=True, fault_plan=plan)
        assert sorted(r.rid for r in rep.results) == \
            sorted(r.rid for r in reqs)

    def test_run_virtual_guards_stalled_policy(self):
        """A policy that declines a non-empty queue after the last
        arrival must surface as a clear error, not a None TypeError."""
        class Never(bt.AdmissionPolicy):
            def decide(self, *a, **k):
                return bt.Admission(False, wait_until=None)

        sched = E.SlotScheduler(Never(lambda b: 0.0, max_batch=4))
        reqs = [bt.Request(0.0, 1.0, 0)]
        with pytest.raises(RuntimeError, match="declined"):
            sched.run_virtual(reqs)


# ---------------------------------------------------------------------------
# per-class metrics + goodput
# ---------------------------------------------------------------------------

def test_per_class_metrics_and_goodput(dense_setup, trace):
    cfg, params = dense_setup
    reqs, _ = trace
    rep = _engine(cfg, params).serve(reqs)
    assert set(rep.class_p99_latency_s) == {"interactive", "batch"}
    assert set(rep.class_mean_ttft_s) == {"interactive", "batch"}
    assert set(rep.class_p99_ttft_s) == {"interactive", "batch"}
    assert all(v > 0 for v in rep.class_p99_latency_s.values())
    # synthetic deadlines are infinite: everything is goodput
    assert rep.slo_attainment == 1.0
    assert rep.goodput_tokens_per_s == pytest.approx(rep.tokens_per_s)


def test_per_class_metrics_equal_the_jax_engines(trace):
    """The per-class tails of one virtual-clock serve are the JAX
    engine's, to the float: both run the same tick loop."""
    jcfg, cfg, jq, params = _setup()
    reqs, _ = trace
    jreqs = JE.synthetic_requests(
        10, rate_per_s=2000.0, vocab=cfg.vocab, prompt_len=3,
        max_new_tokens=5, priority=_two_class)
    policy = bt.AdmissionPolicy(lambda b: 0.0, max_batch=4,
                                max_wait_s=0.0, class_quotas={"batch": 1})
    jpolicy = jbt.AdmissionPolicy(lambda b: 0.0, max_batch=4,
                                  max_wait_s=0.0, class_quotas={"batch": 1})
    rep = _engine(cfg, params, policy=policy).serve(reqs)
    jrep = JE.Engine(jcfg, jq, mode=JW8A16, num_slots=4, max_seq=MAX_SEQ,
                     prefill_chunk=2, policy=jpolicy).serve(jreqs)
    for name in ("class_p99_latency_s", "class_mean_ttft_s",
                 "class_p99_ttft_s", "goodput_tokens_per_s",
                 "slo_attainment", "p99_latency_s", "mean_ttft_s"):
        assert getattr(rep, name) == getattr(jrep, name), name
    assert [(r.rid, r.admit_s, r.finish_s, r.slot) for r in rep.results] \
        == [(r.rid, r.admit_s, r.finish_s, r.slot) for r in jrep.results]


# ---------------------------------------------------------------------------
# preemption storm: the property test
# ---------------------------------------------------------------------------

_STORM = {}


def _storm_setup():
    """Module-cached engine + trace + reference for the property test
    (the hypothesis shim's @given cannot consume pytest fixtures)."""
    if not _STORM:
        _, cfg, _, params = _setup()
        reqs = E.synthetic_requests(
            12, rate_per_s=4000.0, vocab=cfg.vocab, prompt_len=3,
            max_new_tokens=4,
            priority=lambda rid: "batch" if rid % 2 else "interactive")
        want = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                                   max_seq=MAX_SEQ, device="cpu")
        eng = _engine(cfg, params, block_size=4, num_blocks=9)
        _STORM["setup"] = (eng, reqs, want)
    return _STORM["setup"]


@given(st.integers(0, 1000))
@settings(max_examples=5, deadline=None)
def test_preemption_storm_property(seed):
    """Random fault plans over an under-provisioned pool: refcounts stay
    non-negative (BlockPool raises internally otherwise), the pool
    drains to its initial free count (no leaks), and every non-failed
    output is bit for bit the reference."""
    torch.set_num_threads(1)
    eng, reqs, want = _storm_setup()
    plan = FaultPlan.random(seed, n_faults=8, max_tick=120, num_slots=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rep = eng.serve(reqs, preemption=True, fault_plan=plan)
    assert rep.leaked_blocks == 0
    assert sorted(r.rid for r in rep.results) == [r.rid for r in reqs]
    for r in rep.results:
        if r.status == "ok":
            assert r.tokens == want[r.rid], \
                f"rid {r.rid} diverged under fault seed {seed}"
