"""The port's replica router (``repro_torch/engine/router.py``) on the CPU
at reduced size, against the JAX package's (tests/test_router.py's cases
on the port).

The router is host logic on ``core/batching.py``: for one trace and one
set of policies the port's ``route`` must give the JAX router's plan —
assignments, refusals and every decision's projected state — over seeds,
rates and quotas.  Its decisions must replay through each replica's own
``AdmissionPolicy`` and launch; routed outputs must equal dedicated
engines serving each replica's sub-trace, bit for bit."""
import dataclasses

import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # offline: no network, no pip
    from _hypothesis_compat import given, settings, strategies as st

from repro import engine as JE
from repro.core import batching as jbt
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core import batching as bt
from repro_torch.core.qlinear import W8A16
from repro_torch.models import registry as R

MAX_SEQ = 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dense_setup():
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    return cfg, R.init_quantized(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")


def _replicas(cfg, params, n=2, *, policy=None, num_slots=4, **kw):
    return [E.Engine(cfg, params, mode=W8A16, device="cpu",
                     num_slots=num_slots, max_seq=MAX_SEQ, prefill_chunk=2,
                     policy=policy() if policy else None, **kw)
            for _ in range(n)]


class _FakeEngine:
    """Just enough Engine surface for ``ReplicaRouter.route``: the
    projection reads num_slots, multi, lanes, name and policy only."""
    name = None

    def __init__(self, *, num_slots, policy, multi=False):
        self.num_slots = num_slots
        self.policy = policy
        self.multi = multi
        self.lanes = {"a": None, "b": None} if multi else {None: None}


def _fake_router(pkg, policies, multi):
    rt = pkg.ReplicaRouter.__new__(pkg.ReplicaRouter)
    rt.engines = [_FakeEngine(num_slots=4, policy=p, multi=multi)
                  for p in policies]
    rt.names = [f"r{i}" for i in range(len(policies))]
    return rt


def _policies(batch, quotas, service_s, n):
    return [batch.AdmissionPolicy(lambda b: service_s, max_batch=4,
                                  max_wait_s=0.0, class_quotas=quotas)
            for _ in range(n)]


def _plan_of(plan):
    return ({n: [r.rid for r in sub] for n, sub in plan.assignments.items()},
            [r.rid for r in plan.refused],
            [(d.rid, d.replica, d.now, d.capacity, d.active_by_class)
             for d in plan.decisions])


# quota sets, single-model (class keys) and multiplexed (model keys too)
QUOTAS = [None, {"batch": 1}, {"batch": 2}, {"batch": 0},
          {"a": 2}, {"a": 1, "batch": 1, ("b", "interactive"): 2}]


@given(st.integers(0, 30), st.sampled_from([500.0, 5000.0, 50000.0]),
       st.sampled_from(range(len(QUOTAS))), st.sampled_from([2, 3]))
@settings(max_examples=25, deadline=None)
def test_route_plan_equals_the_jax_routers(seed, rate, qi, n_replicas):
    """The same trace, replicas and policies through both packages'
    ``ReplicaRouter.route``: equal assignments, refusals and decisions
    (projected time, capacity and per-key usage).  Quotas on model keys
    route a multiplexed trace (``multi`` replicas, requests tagged a or
    b)."""
    quotas = QUOTAS[qi]
    multi = any(k in ("a", "b") or isinstance(k, tuple)
                for k in (quotas or {}))
    plans = []
    for pkg, batch in ((E, bt), (JE, jbt)):
        rt = _fake_router(pkg, _policies(batch, quotas, 1e-4, n_replicas),
                          multi)
        reqs = pkg.synthetic_requests(
            40, rate_per_s=rate, vocab=256, prompt_len=3, max_new_tokens=4,
            seed=seed,
            priority=lambda rid: "batch" if rid % 2 else "interactive",
            model=(lambda rid: "a" if rid % 3 else "b") if multi else None)
        plans.append(_plan_of(rt.route(reqs)))
    assert plans[0] == plans[1]


@given(st.integers(0, 30), st.sampled_from([500.0, 5000.0, 50000.0]),
       st.sampled_from([None, 1, 2]))
@settings(max_examples=10, deadline=None)
def test_router_never_overrides_replica_policy(seed, rate, batch_quota):
    """Every decision replays through its replica's own policy on exactly
    the projected state the router consulted, and launches; every
    request is assigned once or refused."""
    quotas = {"batch": batch_quota} if batch_quota is not None else None
    rt = _fake_router(E, _policies(bt, quotas, 1e-4, 2), False)
    reqs = E.synthetic_requests(
        40, rate_per_s=rate, vocab=256, prompt_len=3, max_new_tokens=4,
        seed=seed, priority=lambda rid: "batch" if rid % 2 else "interactive")
    plan = rt.route(reqs)
    by_rid = {r.rid: r for r in reqs}
    assert plan.decisions
    for dec in plan.decisions:
        r = by_rid[dec.rid]
        eng = rt.engines[rt.names.index(dec.replica)]
        act = eng.policy.decide(
            dec.now, [r.deadline_s], next_arrival=None,
            capacity=dec.capacity, classes=[r.priority],
            active_by_class=dict(dec.active_by_class))
        assert act.launch and act.batch >= 1, dec
    routed = [r.rid for sub in plan.assignments.values() for r in sub]
    assert sorted(routed + [r.rid for r in plan.refused]) == sorted(by_rid)


def test_router_validates_construction(dense_setup):
    cfg, params = dense_setup
    with pytest.raises(ValueError, match="at least one"):
        E.ReplicaRouter([])
    with pytest.raises(ValueError, match="names"):
        E.ReplicaRouter(_replicas(cfg, params, 2), names=["only-one"])
    with pytest.raises(ValueError, match="unique"):
        E.ReplicaRouter(_replicas(cfg, params, 2), names=["r", "r"])
    engines = _replicas(cfg, params, 2)
    rt = E.ReplicaRouter(engines)
    assert rt.names == ["replica0", "replica1"]
    assert [e.name for e in engines] == rt.names   # names stick


def test_router_rejects_mismatched_lane_sets(dense_setup):
    cfg, params = dense_setup
    kw = dict(mode=W8A16, device="cpu", num_slots=4, max_seq=MAX_SEQ)
    single = E.Engine(cfg, params, **kw)
    multi = E.Engine(models={"a": (cfg, params)}, **kw)
    with pytest.raises(ValueError, match="same model lanes"):
        E.ReplicaRouter([single, multi])


def test_hard_capped_quota_is_refused_typed(dense_setup):
    """A class whose quota is 0 on every replica cannot be routed:
    ``route`` returns it in ``refused`` and ``serve`` gives it the typed
    ``refused`` status with no tokens and slot -1; the rest are served."""
    cfg, params = dense_setup

    def policy():
        return bt.AdmissionPolicy(lambda b: 0.0, max_batch=4,
                                  max_wait_s=0.0, class_quotas={"batch": 0})

    rt = E.ReplicaRouter(_replicas(cfg, params, 2, policy=policy))
    reqs = E.synthetic_requests(
        8, rate_per_s=2000.0, vocab=cfg.vocab, prompt_len=3,
        max_new_tokens=4,
        priority=lambda rid: "batch" if rid % 2 else "interactive")
    plan = rt.route(reqs)
    assert {r.rid for r in plan.refused} == \
        {r.rid for r in reqs if r.priority == "batch"}
    rep = rt.serve(reqs, tick_s=1e-3)
    assert len(rep.results) == len(reqs)
    for r in rep.results:
        want = "refused" if r.priority == "batch" else "ok"
        assert r.status == want
    assert rep.refused == len(plan.refused)
    assert all(r.tokens == [] and r.slot == -1 for r in rep.results
               if r.status == "refused")


@pytest.mark.parametrize("block_size", [None, 4])
def test_routed_outputs_equal_dedicated_engines(dense_setup, block_size):
    """Two replicas on one hot trace: each replica's outputs equal a
    dedicated engine's on its sub-trace and the sequential reference's,
    both replicas take work, and the rollup's accounting holds."""
    cfg, params = dense_setup
    kw = dict(block_size=block_size)
    rt = E.ReplicaRouter(_replicas(cfg, params, 2, **kw))
    reqs = E.synthetic_requests(24, rate_per_s=20000.0, vocab=cfg.vocab,
                                prompt_len=4, max_new_tokens=5)
    plan = rt.route(reqs)
    rep = rt.serve(reqs, tick_s=1e-3)
    for name, sub in plan.assignments.items():
        assert sub
        ded = _replicas(cfg, params, 1, **kw)[0].serve(sub, tick_s=1e-3)
        assert rep.replicas[name].outputs() == ded.outputs(), name
    assert rep.outputs() == E.reference_outputs(
        cfg, params, reqs, mode=W8A16, max_seq=MAX_SEQ, device="cpu")
    assert rep.refused == 0
    assert sum(rep.replica_requests.values()) == len(reqs)
    assert rep.generated_tokens == sum(
        r.generated_tokens for r in rep.replicas.values())
    assert rep.duration_s == max(r.duration_s for r in rep.replicas.values())
    assert rep.leaked_blocks == 0


def test_routed_multiplexed_replicas(dense_setup):
    """Replicas that are multiplexed engines: the plan meters (model,
    class) keys, and every lane of every replica equals a dedicated
    engine on that lane's part of the replica's sub-trace."""
    cfg, params = dense_setup
    lanes = {"a": (cfg, params), "b": (cfg, params)}
    fleet = [E.Engine(models=lanes, mode=W8A16, device="cpu", num_slots=4,
                      max_seq=MAX_SEQ, prefill_chunk=2) for _ in range(2)]
    rt = E.ReplicaRouter(fleet)
    reqs = E.synthetic_requests(16, rate_per_s=20000.0, vocab=cfg.vocab,
                                prompt_len=4, max_new_tokens=5,
                                model=lambda rid: "ab"[rid // 2 % 2])
    plan = rt.route(reqs)
    rep = rt.serve(reqs, tick_s=1e-3)
    want = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                               max_seq=MAX_SEQ, device="cpu")
    assert rep.outputs() == want
    for sub in plan.assignments.values():
        assert {r.model for r in sub} == {"a", "b"}


def test_route_plan_is_deterministic(dense_setup):
    cfg, params = dense_setup
    reqs = E.synthetic_requests(30, rate_per_s=20000.0, vocab=cfg.vocab,
                                prompt_len=4, max_new_tokens=5)
    a, b = (_plan_of(E.ReplicaRouter(_replicas(cfg, params, 3)).route(reqs))
            for _ in range(2))
    assert a == b
