"""The MoE family — qwen2-moe-a2.7b — against the JAX package on the CPU at
reduced size: the MoE FFN (routing, drops, the experts' stacked product),
the full-sequence forward and the decode step on the bf16 and the int8
KV cache, contiguous and paged, the chunk step's one pass, the engine,
the streamed init, the experts' plain version and the serve CLI.

``cfg.reduced()`` leaves 4 experts, top-2, and a (128, 4) router whose
512 elements stay below ``quantize_tree``'s ``min_size`` of 2,048: an f32
router through ``torch.matmul``, which at full width is an int8 QTensor
through the W8A16 GEMV.  The test config keeps the full-width properties
through ``dataclasses.replace`` (the same ``ArchConfig`` values in both
packages): 16 experts, top-4 (a (128, 16) router of 2,048 elements, so
int8), G = 1 with 16 KV heads (which sends the reference's contiguous
``decode_step`` down its append-outside-scan branch), the published
``capacity_factor`` 1.25 (so a full sequence drops tokens) and experts of
d_ff 64.  The engine's bit parity with its own reference is claimed for
that quantized router, as at full width; the f32 router is held to the
reference within tolerance.

The same weights go into both packages (the reference's ``init`` and
``quantize_tree``, copied through numpy by ``models/bridge.py``); inputs
come from numpy with a seed.  A router difference of an ulp can swap the
k-th and (k+1)-th experts of a token whose two probabilities nearly tie,
which changes that token's row by O(1): expert choices are compared
where the reference's k-th and (k+1)-th probabilities are more than
ROUTE_TIE apart (MODEL_ROUTE_TIE through a whole model), and a row whose
choices differ is left out of the output comparison (through a model,
from that step on).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs import get_config as jget_config
from repro.core.qlinear import FP as JFP, W8A8 as JW8A8, W8A16 as JW8A16
from repro.core.qlinear import linear as jlinear
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import moe as JM
from repro.models import registry as JR
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core.qlinear import W8A8, W8A16
from repro_torch.core.quant import QTensor, quantize_tree
from repro_torch.kernels import ops
from repro_torch.kernels import qmatmul as K
from repro_torch.kernels.qmatmul import activate
from repro_torch.launch import serve
from repro_torch.models import bridge
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.runtime import steps as ST

from test_torch_dense_family import _tables, _tree_equal
from test_torch_engine import _jax_reference_with_margins
from test_torch_forward import W8A8_LOGIT_ATOL, _check_logits
from test_torch_model import LOGIT_ATOL, to_numpy

ARCH = "qwen2-moe-a2.7b"
# the fields that keep the full-width properties at reduced size
QUIRKS = dict(n_experts=16, top_k=4, n_heads=16, n_kv_heads=16, d_ff=64,
              capacity_factor=1.25)
# cache kind -> (paged, kv_quant)
CACHES = {"bf16": (False, False), "bf16_paged": (True, False),
          "int8": (False, True), "int8_paged": (True, True)}
BS, MAX_SEQ = 4, 16
PROMPT, GEN, SHARED = 6, 5, 4
# a near-tie of the reference's k-th and (k+1)-th probabilities: the port's
# router (another order of f32 adds) may pick either expert
ROUTE_TIE = 1e-4
# the same through a whole model: the hidden states that reach a router
# differ by the two packages' bf16 roundings, which moves its
# probabilities by up to ~1e-3
MODEL_ROUTE_TIE = 3e-3
# the MoE FFN's rows against the reference's, bf16 out: both round the
# experts' products and the combine to bf16 at other places (the silu
# before or after the rounding, the combine's sum in f32 or bf16), a few
# bf16 ulps of values of magnitude ~2
FFN_ATOL = 0.05


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(kv_quant=False, **fields):
    fields = {**QUIRKS, **fields}
    return tuple(dataclasses.replace(get(ARCH).reduced(), kv_quant=kv_quant,
                                     **fields)
                 for get in (jget_config, get_config))


_PARAMS = {}


def _params(**fields):
    """(jax int8 params, the port's copy of them), made once per config."""
    key = tuple(sorted(fields.items()))
    if key not in _PARAMS:
        jcfg, _ = _cfgs(**fields)
        jq = jquantize_tree(JR.init(jax.random.PRNGKey(0), jcfg),
                            min_size=2048)
        _PARAMS[key] = jq, bridge.params_from_numpy(to_numpy(jq),
                                                    device="cpu")
    return _PARAMS[key]


def _trace(vocab, n=8):
    return dict(n=n, rate_per_s=2000.0, vocab=vocab, prompt_len=PROMPT,
                max_new_tokens=GEN, shared_prefix_len=SHARED)


# ---------------------------------------------------------------------------
# the config, the registry and the streamed init
# ---------------------------------------------------------------------------

def test_arch_file_matches_reference():
    """The port's arch file holds the JAX one's values field by field, at
    full width and reduced, and the registry serves it (paging too)."""
    j, t = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert t.family == "moe" and not t.kv_quant and R.supports_paging(t)
    assert R.module_for(t) is M
    assert (t.n_experts, t.top_k, t.n_shared_experts) == (60, 4, 4)


def test_full_width_int8_bytes():
    """The int8 weight bytes at full width, from the shapes alone: 24
    layers of attention, router, routed experts and shared MLP, and the
    tied table (scales not counted)."""
    c = get_config(ARCH)
    d, f, e = c.d_model, c.d_ff, c.n_experts
    layer = (4 * d * d + d * e + 3 * e * d * f
             + 3 * d * f * c.n_shared_experts)
    assert layer == 16_777_216 + 122_880 + 519_045_120 + 34_603_008
    assert c.n_layers * layer + c.vocab * d == 14_004_322_304


@pytest.mark.parametrize("fields", [{}, {"n_experts": 4, "top_k": 2}],
                         ids=["int8_router", "f32_router"])
def test_streamed_init_equals_quantize_tree(fields, monkeypatch):
    """``registry.init_quantized`` is ``quantize_tree(init(...),
    min_size=2048)`` from the same seed, bit for bit: the router is an
    int8 QTensor exactly when its (D, E) has 2,048 elements or more, the
    experts' stacks quantize with one scale per (expert, column)."""
    monkeypatch.setattr(T, "TABLE_ROW_CHUNK", 100)
    _, cfg = _cfgs(**fields)
    whole = quantize_tree(R.init(torch.Generator().manual_seed(7), cfg,
                                 device="cpu"), min_size=2048)
    streamed = R.init_quantized(torch.Generator().manual_seed(7), cfg,
                                device="cpu")
    assert _tree_equal(whole, streamed)
    moe = streamed["layers"][1]["moe"]
    assert isinstance(moe["router"]["w"], QTensor) == (
        cfg.d_model * cfg.n_experts >= 2048)
    gate = moe["experts"]["w_gate"]
    assert isinstance(gate, QTensor)
    assert gate.scale.shape == (cfg.n_experts, 1, cfg.d_ff)
    assert isinstance(moe["shared"]["w_down"]["w"], QTensor)
    assert ST._projections_quantized(streamed) == isinstance(
        moe["router"]["w"], QTensor)


def test_projections_quantized_sees_the_moe_weights():
    """The chunk step's one-pass test looks at the router, each expert
    stack and the shared MLP: any of them left f32 sends the chunk down
    the per-token loop."""
    _, tq = _params()
    assert ST._projections_quantized(tq)
    for path in (("router", "w"), ("experts", "w_up"),
                 ("shared", "w_gate", "w")):
        layers = [dict(lp, moe=_replaced(lp["moe"], path)) for lp in
                  tq["layers"]]
        assert not ST._projections_quantized(dict(tq, layers=layers)), path


def _replaced(tree, path):
    """``tree`` with the QTensor at ``path`` dequantized to f32."""
    if len(path) == 1:
        q = tree[path[0]]
        return dict(tree, **{path[0]: q.values.float() * q.scale})
    return dict(tree, **{path[0]: _replaced(tree[path[0]], path[1:])})


# ---------------------------------------------------------------------------
# the experts' stacked product
# ---------------------------------------------------------------------------

def test_experts_plain_version_is_the_2d_one_per_expert():
    """``qmatmul_w8a16_experts_ref`` is ``qmatmul_w8a16_ref`` per expert,
    bitwise, with (E, N) or the quantizer's (E, 1, N) scales, and ops'
    dispatch sends a CPU stack there."""
    gen = torch.Generator().manual_seed(3)
    e, m, k, n = 5, 3, 64, 24
    w = torch.randint(-127, 128, (e, k, n), generator=gen, dtype=torch.int8)
    scale = torch.rand((e, 1, n), generator=gen) * 0.01 + 1e-3
    x = torch.randn((e, m, k), generator=gen).to(torch.bfloat16)
    for act, odt in (("silu", torch.bfloat16), ("none", torch.float32)):
        got = K.qmatmul_w8a16_experts_ref(x, w, scale, activation=act,
                                          out_dtype=odt)
        assert got.shape == (e, m, n) and got.dtype == odt
        for i in range(e):
            assert torch.equal(got[i], K.qmatmul_w8a16_ref(
                x[i], w[i], scale[i].reshape(-1), activation=act,
                out_dtype=odt))
        assert torch.equal(got, K.qmatmul_w8a16_experts_ref(
            x, w, scale.reshape(e, n), activation=act, out_dtype=odt))
    launches = K.qmatmul_w8a16_experts.launches
    assert torch.equal(ops.qmatmul_experts(x, QTensor(w, scale)),
                       K.qmatmul_w8a16_experts_ref(x, w, scale))
    assert K.qmatmul_w8a16_experts.launches == launches


def test_experts_split_plan():
    """The stack's plan counts E x strips blocks against the wave: a stack
    of one is the 2-D GEMV's plan, qwen2-moe-a2.7b's 60 experts take one
    split (no workspace) at each of its three shapes, and the scratch of
    a split stack has a share per expert."""
    for k, n in ((2048, 1408), (1408, 2048), (128, 64), (4096, 60)):
        assert K.gemv_experts_plan(1, k, n) == K.gemv_split_plan(k, n)
    c = get_config(ARCH)
    for k, n in ((c.d_model, c.d_ff), (c.d_ff, c.d_model)):
        plan, work, counters = K.gemv_experts_launch(c.n_experts, 8, k, n)
        assert plan.splits == 1 and work == counters == 0
    plan, work, counters = K.gemv_experts_launch(16, 9, 128, 64)
    assert plan.strips == 1 and plan.splits == 2
    assert work == 2 * 16 * 9 * 64 and counters == 16 * 2 * 1
    with pytest.raises(ValueError, match="E >= 1"):
        K.gemv_experts_plan(0, 128, 64)
    with pytest.raises(ValueError, match="K % 8"):
        K.gemv_experts_plan(4, 100, 64)


@pytest.mark.parametrize("bad,match", [
    (dict(activation="swish"), "activation"),
    (dict(x=(4, 64)), "stack"),
    (dict(x=(3, 2, 64)), "stack"),
    (dict(x=(4, 2, 32)), "stack"),
    (dict(w_dtype=torch.float32), "int8"),
    (dict(scale=(4, 1, 12)), "E x N"),
    (dict(x_dtype=torch.float16), "f32 or bf16"),
    ({}, "CUDA"),
    (dict(path="tc"), "unknown path"),
    (dict(path="mma", x_dtype=torch.float32), "mma path takes bf16"),
    (dict(live=torch.ones((4, 3), dtype=torch.uint8)), r"live must be \(E, M\)"),
    (dict(live=torch.ones((4, 2), dtype=torch.bool)), r"live must be \(E, M\)"),
    (dict(live=torch.ones((4, 2), dtype=torch.uint8, device="meta")),
     "x's device"),
    (dict(live=torch.ones((2, 4), dtype=torch.uint8).t()), "contiguous"),
])
def test_experts_wrapper_checks_its_arguments(bad, match):
    """The kernel's wrapper refuses what the kernel does not take (a
    live mask not (E, M) uint8, contiguous on x's device; f32 x on the
    mma path), and a CPU stack (the plain version's) before it would
    launch."""
    x = torch.zeros(bad.get("x", (4, 2, 64)),
                    dtype=bad.get("x_dtype", torch.bfloat16))
    w = torch.zeros((4, 64, 24), dtype=bad.get("w_dtype", torch.int8))
    scale = torch.ones(bad.get("scale", (4, 1, 24)))
    launches = K.qmatmul_w8a16_experts.launches
    by_path = dict(K.qmatmul_w8a16_experts.launches_by_path)
    with pytest.raises(ValueError, match=match):
        K.qmatmul_w8a16_experts(x, w, scale, live=bad.get("live"),
                                path=bad.get("path", "gemv"),
                                activation=bad.get("activation", "none"))
    assert K.qmatmul_w8a16_experts.launches == launches
    assert K.qmatmul_w8a16_experts.launches_by_path == by_path


@pytest.mark.parametrize("act", K.ACTIVATIONS)
def test_experts_plain_version_writes_act0_on_dead_rows(act):
    """``qmatmul_w8a16_experts_ref`` with a live mask: bitwise the
    unmasked stack where the dead rows of x are zero (the dispatch stack's
    case, what today's callers see), and where they are not, the live
    rows unchanged and every dead row ``act(0)`` (sigmoid's 0.5); ops'
    dispatch passes the mask to it on the CPU."""
    gen = torch.Generator().manual_seed(7)
    e, m, k, n = 4, 5, 64, 24
    w = torch.randint(-127, 128, (e, k, n), generator=gen, dtype=torch.int8)
    scale = torch.rand((e, 1, n), generator=gen) * 0.01 + 1e-3
    live = (torch.rand((e, m), generator=gen) < 0.5).to(torch.uint8)
    live[0] = 0                                   # a dead expert
    live[1] = 1                                   # an expert all live
    x = torch.randn((e, m, k), generator=gen).to(torch.bfloat16)
    zeroed = x * live[..., None]
    dead = activate(torch.zeros(()), act).to(torch.bfloat16)
    for odt in (torch.bfloat16, torch.float32):
        full = K.qmatmul_w8a16_experts_ref(zeroed, w, scale, activation=act,
                                           out_dtype=odt)
        assert torch.equal(K.qmatmul_w8a16_experts_ref(
            zeroed, w, scale, live=live, activation=act, out_dtype=odt),
            full)
        got = K.qmatmul_w8a16_experts_ref(x, w, scale, live=live,
                                          activation=act, out_dtype=odt)
        want = K.qmatmul_w8a16_experts_ref(x, w, scale, activation=act,
                                           out_dtype=odt)
        mask = live.bool()
        assert torch.equal(got[mask], want[mask])
        assert (got[~mask] == dead.to(odt)).all()
    if act == "sigmoid":
        assert dead.item() == 0.5
    assert torch.equal(
        ops.qmatmul_experts(x, QTensor(w, scale), live=live, path="mma",
                            activation=act),
        K.qmatmul_w8a16_experts_ref(x, w, scale, live=live, activation=act))


# ---------------------------------------------------------------------------
# routing and the MoE FFN against the reference
# ---------------------------------------------------------------------------

def _jax_route(p, x, cfg):
    """The reference's routing (``repro/models/moe.py:87-97``) of x (B, S,
    D): (sorted probabilities (B, S, E), top_e (B, S, k), keep (B, S·k))."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = int(math.ceil(s * k / e * cfg.capacity_factor))
    logits = jlinear(p["router"], x.astype(jnp.float32), mode=JFP,
                     compute_dtype=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(b, s * k)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, e, dtype=jnp.int32), axis=1) - 1
    my_pos = jnp.take_along_axis(pos, flat_e[..., None], axis=2)[..., 0]
    return (np.sort(np.asarray(probs), axis=-1)[..., ::-1], np.asarray(top_e),
            np.asarray(my_pos < cap))


def _check_ffn(jp, tp, jcfg, cfg, x, *, per_token=False):
    """The port's moe_ffn against the reference's on x (B, S, D) f32
    (bf16 in both): expert choices equal on every token whose k-th and
    (k+1)-th reference probabilities are ROUTE_TIE apart; ``keep`` equal
    on every row where all the choices are; those rows' outputs within
    FFN_ATOL.  Returns the number of dropped assignments."""
    b, s, d = x.shape
    k = cfg.top_k
    xb = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    if per_token:       # the reference routes each token of a chunk alone
        xb, tx = xb.reshape(b * s, 1, d), tx.reshape(b * s, 1, d)
    probs, want_e, want_keep = _jax_route(jp, xb, jcfg)
    top_p, got_e = M.route(tp["router"], tx, k)
    cap = int(math.ceil(tx.shape[1] * k / cfg.n_experts
                        * cfg.capacity_factor))
    _, got_keep = M.dispatch(got_e, cap, cfg.n_experts)
    clear = (probs[..., k - 1] - probs[..., k]) > ROUTE_TIE
    np.testing.assert_array_equal(got_e.numpy()[clear], want_e[clear])
    np.testing.assert_allclose(top_p.sum(-1).numpy(), 1.0, rtol=1e-6)
    same_row = (got_e.numpy() == want_e).all(axis=(1, 2))
    assert same_row.mean() >= 0.5, same_row
    np.testing.assert_array_equal(got_keep.numpy()[same_row],
                                  want_keep[same_row])
    want = np.asarray(JM.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                                 mode=JW8A16).astype(jnp.float32)) \
        if not per_token else np.asarray(JM.moe_ffn(
            jp, xb, jcfg, mode=JW8A16).astype(jnp.float32)).reshape(b, s, d)
    got = M.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), cfg,
                    mode=W8A16, per_token=per_token).float().numpy()
    rows = same_row.reshape(b, -1).all(axis=1) if not per_token else \
        same_row.reshape(b, s)
    assert np.abs(got - want)[rows].max() <= FFN_ATOL
    return int((~want_keep).sum())


@pytest.mark.parametrize("case", ["decode", "sequence", "per_token"])
def test_moe_ffn_matches_reference(case):
    """One layer's MoE FFN against the reference's: one token per row (a
    decode tick: capacity 1, nothing dropped), a (2, 24) sequence at the
    published capacity factor 1.25 (capacity 8 for 24 x 4 assignments
    over 16 experts: tokens drop, the same as the reference's), and the
    same sequence routed a token at a time (the chunk step's pass)."""
    jcfg, cfg = _cfgs()
    jq, tq = _params()
    jp = jax.tree_util.tree_map(lambda a: a[0], jq["layers"])["moe"]
    tp = tq["layers"][0]["moe"]
    b, s = {"decode": (8, 1), "sequence": (2, 24), "per_token": (2, 24)}[case]
    x = np.random.default_rng(5).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    dropped = _check_ffn(jp, tp, jcfg, cfg, x,
                         per_token=case == "per_token")
    assert (dropped > 0) == (case == "sequence"), dropped


def test_f32_router_matches_reference():
    """``reduced()``'s own 4 experts, top-2: the (128, 4) router stays f32
    (``torch.matmul`` on the CPU, not row-invariant, so no bit parity is
    claimed for it), held to the reference within tolerance on a (2, 24)
    sequence."""
    fields = {"n_experts": 4, "top_k": 2}
    jcfg, cfg = _cfgs(**fields)
    jq, tq = _params(**fields)
    jp = jax.tree_util.tree_map(lambda a: a[0], jq["layers"])["moe"]
    tp = tq["layers"][0]["moe"]
    assert not isinstance(tp["router"]["w"], QTensor)
    x = np.random.default_rng(6).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    _check_ffn(jp, tp, jcfg, cfg, x)


def test_ties_go_to_the_lower_expert_index():
    """Equal probabilities are taken lowest index first, as
    ``lax.top_k`` takes them: a zero router ties all 16 experts."""
    _, cfg = _cfgs()
    router = {"w": torch.zeros((cfg.d_model, cfg.n_experts))}
    x = torch.randn((3, 2, cfg.d_model))
    _, top_e = M.route(router, x, cfg.top_k)
    _, want = jax.lax.top_k(jnp.zeros((3, 2, cfg.n_experts)), cfg.top_k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want))
    assert top_e[0, 0].tolist() == [0, 1, 2, 3]


def test_dispatch_drops_in_the_references_order():
    """Places in the stack follow the cumsum over a row's (token, choice)
    pairs: an expert's first ``cap`` assignments are kept, in token
    order, and a dropped one points at its expert's first place of the
    row."""
    top_e = torch.tensor([[[0, 1], [0, 2], [0, 1]],
                          [[2, 0], [2, 1], [1, 0]]])
    place, keep = M.dispatch(top_e, cap=2, e=3)
    rows = 2 * 2
    assert keep.tolist() == [[True, True, True, True, False, True],
                             [True, True, True, True, True, True]]
    assert place.tolist() == [
        [0 * rows + 0, 1 * rows + 0, 0 * rows + 1, 2 * rows + 0,
         0 * rows + 0, 1 * rows + 1],
        [2 * rows + 2, 0 * rows + 2, 2 * rows + 3, 1 * rows + 2,
         1 * rows + 3, 0 * rows + 3]]


def test_live_rows_flag_the_kept_places():
    """The live mask of the drop case above: exactly the places a kept
    assignment fills, (E, B·cap) uint8; a dropped assignment's place (its
    expert's first of the row) is live, as its expert's capacity there is
    full."""
    top_e = torch.tensor([[[0, 1], [0, 2], [0, 1]],
                          [[2, 0], [2, 1], [1, 0]]])
    place, keep = M.dispatch(top_e, cap=2, e=3)
    live = M.live_rows(place, keep, 3, 4)
    assert live.shape == (3, 4) and live.dtype == torch.uint8
    want = torch.zeros(12, dtype=torch.uint8)
    want[place[keep]] = 1
    assert torch.equal(live.reshape(-1), want)
    assert live.reshape(-1).tolist() == [1] * 9 + [0] + [1] * 2
    assert (live.reshape(-1)[place[~keep]] == 1).all()


@pytest.fixture
def stacks(monkeypatch):
    """Every ``ops.qmatmul_experts`` call as (path, live, x) and every
    ``moe.dispatch`` result, in call order."""
    seen = {"experts": [], "dispatch": []}
    real, real_dispatch = ops.qmatmul_experts, M.dispatch

    def spy(x, w, **kw):
        seen["experts"].append((kw.get("path", "gemv"), kw.get("live"), x))
        return real(x, w, **kw)

    def dispatch(top_e, cap, e):
        out = real_dispatch(top_e, cap, e)
        seen["dispatch"].append(out)
        return out

    monkeypatch.setattr(ops, "qmatmul_experts", spy)
    monkeypatch.setattr(M, "dispatch", dispatch)
    return seen


@pytest.mark.parametrize("case", ["decode", "sequence", "per_token"])
def test_moe_ffn_live_mask_is_the_combines_kept_places(case, stacks):
    """``moe_ffn`` hands its three expert stacks one live mask: a row
    is live exactly where the combine gathers a kept assignment's place
    (capacity drops in the sequence case, a token at a time per_token),
    every dead row of the dispatch stack is zero, and every place the
    combine gathers (a drop's too) is live."""
    _, cfg = _cfgs()
    _, tq = _params()
    tp = tq["layers"][0]["moe"]
    b, s = {"decode": (8, 1), "sequence": (2, 24), "per_token": (2, 24)}[case]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    M.moe_ffn(tp, x, cfg, mode=W8A16, per_token=case == "per_token")
    (place, keep), = stacks["dispatch"]
    assert (not keep.all()) == (case == "sequence")
    calls = stacks["experts"]
    assert len(calls) == 3 and all(c[1] is calls[0][1] for c in calls)
    live = calls[0][1]
    e, rows = live.shape
    assert (e, rows) == (cfg.n_experts, calls[0][2].shape[1])
    want = torch.zeros(e * rows, dtype=torch.uint8)
    want[place[keep]] = 1
    assert torch.equal(live.reshape(-1), want)
    assert (live.reshape(-1)[place] == 1).all()
    dead = ~live.bool()
    assert (calls[0][2][dead] == 0).all() and dead.any()


@pytest.mark.parametrize("caller", ["forward", "forward_w8a8", "decode_step",
                                    "chunk", "verify"])
def test_experts_path_by_caller(caller, stacks):
    """The full-sequence ``forward`` under W8A16 asks for the experts'
    tensor-core kernel (``"mma"``) at every layer's three stacks; under
    W8A8, and at the decode step, the chunk pass and the verify step,
    every stack takes the GEMV, each with its live mask."""
    _, cfg = _cfgs()
    _, tq = _params()
    mode = W8A8 if caller == "forward_w8a8" else W8A16
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 5)).astype(
        np.int32))
    if caller.startswith("forward"):
        ST.make_prefill_step(cfg, mode=mode)(tq, {"tokens": toks})
    elif caller == "decode_step":
        ST.make_decode_step(cfg, mode=mode)(
            tq, {"tokens": toks[:, :1], "cache_index": 3},
            R.init_cache(cfg, 2, MAX_SEQ, device="cpu"))
    elif caller == "chunk":
        ST.make_prefill_chunk_step(cfg, mode=mode, chunk=4)(
            tq, toks[0, :4].numpy(), R.init_cache(cfg, 2, MAX_SEQ,
                                                  device="cpu"), 1, 0, 3)
    else:
        ST.make_verify_step(cfg, mode=mode, k=2)(
            tq, toks[:, :3], R.init_cache(cfg, 2, MAX_SEQ, device="cpu"),
            torch.tensor([0, 4], dtype=torch.int32),
            torch.tensor([3, 2], dtype=torch.int32),
            torch.tensor([True, True]))
    paths = [c[0] for c in stacks["experts"]]
    want = "mma" if caller == "forward" else "gemv"
    assert len(paths) % (3 * cfg.n_layers) == 0 and len(paths) > 0
    assert set(paths) == {want}
    assert all(c[1] is not None for c in stacks["experts"])


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def _record_routes(monkeypatch):
    """Record every MoE layer's expert choices, in call order: the port's
    (``moe.route``) as (rows, k) arrays, and the reference's as
    (choices, margin) pairs from a ``jax.debug.callback`` on the input of
    its ``moe_ffn`` (the reference's routing recomputed there: top-k of
    the softmax of its router, and the gap between the k-th and (k+1)-th
    probabilities)."""
    port, ref = [], []
    real_route, real_ffn = M.route, JM.moe_ffn

    def route(router, x, k):
        top_p, top_e = real_route(router, x, k)
        port.append(top_e.reshape(-1, k).numpy())
        return top_p, top_e

    def record(choices, margin):
        ref.append((np.asarray(choices), np.asarray(margin)))

    def moe_ffn(p, x, cfg, *, mode):
        k = cfg.top_k
        logits = jlinear(p["router"], x.astype(jnp.float32), mode=JFP,
                         compute_dtype=jnp.float32)
        vals, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k + 1)
        jax.debug.callback(record, top_e[..., :k].reshape(-1, k),
                           (vals[..., k - 1] - vals[..., k]).reshape(-1),
                           ordered=True)
        return real_ffn(p, x, cfg, mode=mode)

    monkeypatch.setattr(M, "route", route)
    monkeypatch.setattr(JM, "moe_ffn", moe_ffn)
    return port, ref


def _parted_rows(port, ref, parted, tie=MODEL_ROUTE_TIE):
    """``parted`` (B,) bool, batch rows whose history already differs from
    the reference's, updated in place with the rows any of whose tokens
    took another set of experts than the reference's in a layer of one
    step (the recorders' entries, emptied here).  Each such difference on
    a row not parted before that layer must sit at a reference near-tie
    (``tie``: MODEL_ROUTE_TIE unless a config's own is given)."""
    assert len(port) == len(ref) > 0
    b = len(parted)
    for got, (want, margin) in zip(port, ref):
        # the set of experts: an order swap within the k changes only the
        # order of the combine's terms
        differ = (np.sort(got, axis=1) != np.sort(want, axis=1)).any(axis=1)
        fresh = differ & ~np.repeat(parted, len(differ) // b)
        assert (margin[fresh] <= tie).all(), margin[fresh]
        parted |= differ.reshape(b, -1).any(axis=1)
    port.clear()
    ref.clear()
    return parted


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_forward_matches_reference(mode, monkeypatch):
    """The full-sequence forward against the JAX forward under jax.jit,
    (4, 12) tokens at the published capacity factor (tokens drop): on
    every batch row routed as the reference routes it, logits within
    LOGIT_ATOL and greedy tokens equal where the reference's top-2 gap is
    outside it (W8A8: W8A8_LOGIT_ATOL); a row routed otherwise parts at a
    reference near-tie.  Under W8A8 the router and the experts stay W8A16
    in both packages."""
    tm, jm = {"w8a16": (W8A16, JW8A16), "w8a8": (W8A8, JW8A8)}[mode]
    atol = W8A8_LOGIT_ATOL if mode == "w8a8" else LOGIT_ATOL
    jcfg, cfg = _cfgs()
    jq, tq = _params()
    port, ref = _record_routes(monkeypatch)
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (4, 12)).astype(
        np.int32)
    want = np.asarray(jax.jit(lambda p, t: JR.apply_forward(
        p, jcfg, {"tokens": t}, mode=jm, remat=False))(jq, jnp.asarray(toks)))
    jax.effects_barrier()
    got = ST.make_prefill_step(cfg, mode=tm)(
        tq, {"tokens": torch.from_numpy(toks)})
    same = ~_parted_rows(port, ref, np.zeros(4, bool))
    assert same.sum() >= 2, same
    _check_logits(got.numpy()[same], want[same], atol)


def _decode_against_reference(kind, monkeypatch, mode=W8A16, jmode=JW8A16):
    """Eight decode steps of four rows at ragged positions on the cache
    ``kind``, the port's and the reference's logits held as
    :func:`test_forward_matches_reference` holds them, a row left out
    from the step it parts on (its later tokens attend a different
    history)."""
    paged, kv_quant = CACHES[kind]
    jcfg, cfg = _cfgs(kv_quant)
    jq, tq = _params()
    port, ref = _record_routes(monkeypatch)
    b, steps = 4, 8
    if paged:
        nb = b * (MAX_SEQ // BS) + 1
        tables = _tables(b, nb, MAX_SEQ // BS, 0)
        jcache = dict(JR.init_paged_cache(jcfg, b, MAX_SEQ, BS, nb),
                      block_tables=jnp.asarray(tables))
        tcache = R.init_paged_cache(cfg, b, MAX_SEQ, BS, nb, device="cpu")
        tcache["block_tables"].copy_(torch.from_numpy(tables))
    else:
        jcache = JR.init_cache(jcfg, b, MAX_SEQ)
        tcache = R.init_cache(cfg, b, MAX_SEQ, device="cpu")
    assert set(tcache) == set(jcache)
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, cfg.vocab, (steps, b, 1)).astype(np.int32)
    start = np.array([0, 3, 7, 1], np.int32)
    jdecode = jax.jit(lambda p, t, c, i: JM.decode_step(p, t, c, i, jcfg,
                                                         mode=jmode))
    decode = ST.make_decode_step(cfg, mode=mode)
    parted, compared = np.zeros(b, bool), 0
    for s in range(steps):
        idx = start + s
        jl, jcache = jdecode(jq, jnp.asarray(tokens[s]), jcache,
                             jnp.asarray(idx))
        jax.effects_barrier()
        tl, tcache = decode(tq, {"tokens": torch.from_numpy(tokens[s]),
                                 "cache_index": torch.from_numpy(idx)},
                            tcache)
        assert tl.dtype == torch.float32
        _parted_rows(port, ref, parted)
        _check_logits(tl.numpy()[~parted], np.asarray(jl)[~parted],
                      W8A8_LOGIT_ATOL if mode.w8a8 else LOGIT_ATOL)
        compared += int((~parted).sum())
    assert compared >= steps * b // 2, compared
    # written at the same places: a (token, head) whose scale (int8) or
    # values (bf16) are not all zero
    for name in (("k_scale", "v_scale") if kv_quant else ("k", "v")):
        got = (tcache[name].float().numpy() != 0).any(-1)
        want = (np.asarray(jcache[name]).astype(np.float32) != 0).any(-1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(CACHES))
def test_decode_step_matches_reference(kind, monkeypatch):
    """Eight W8A16 decode steps, four rows at ragged per-row positions, on
    the cache ``kind`` (paged: each row on shuffled physical blocks): the
    logits within LOGIT_ATOL of the JAX decode_step's on every row still
    routed as the reference routes it, greedy tokens equal where the
    reference's top-2 gap is outside it, and both caches written at the
    same places."""
    _decode_against_reference(kind, monkeypatch)


def test_w8a8_decode_step_matches_reference(monkeypatch):
    """The same under W8A8 on the bf16 cache: the attention and the shared
    MLP on int8 activations, the router and the experts W8A16, in both
    packages."""
    _decode_against_reference("bf16", monkeypatch, W8A8, JW8A8)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_paged_decode_step_equals_contiguous_bitwise(kv_quant):
    """The same history decoded into a paged cache and into contiguous
    rows: bit-identical logits at every step (one token, then a causal
    pass of three, routed a token at a time), and the gathered paged
    rows equal the contiguous rows byte for byte up to each frontier."""
    _, cfg = _cfgs(kv_quant)
    _, tq = _params()
    b, nb = 3, 3 * (MAX_SEQ // BS) + 2
    tables = _tables(b, nb, MAX_SEQ // BS, 1)
    paged = R.init_paged_cache(cfg, b, MAX_SEQ, BS, nb, device="cpu")
    paged["block_tables"].copy_(torch.from_numpy(tables))
    contig = R.init_cache(cfg, b, MAX_SEQ, device="cpu")
    rng = np.random.default_rng(1)
    pos = torch.tensor([0, 5, 2], dtype=torch.int32)
    for s in (1, 1, 3, 1, 3):
        toks = torch.from_numpy(rng.integers(1, cfg.vocab, (b, s)).astype(
            np.int32))
        lp, _ = M.decode_step(tq, toks, paged, pos, cfg, mode=W8A16,
                              causal=True)
        lc, _ = M.decode_step(tq, toks, contig, pos, cfg, mode=W8A16,
                              causal=True)
        assert torch.equal(lp, lc)
        pos = pos + s
    for key in contig:
        got = L.paged_gather(paged[key][1], paged["block_tables"])
        for r in range(b):
            n = int(pos[r])
            assert torch.equal(got[r, :n], contig[key][1][r, :n])


@pytest.mark.parametrize("kind", list(CACHES))
def test_chunk_pass_equals_per_token_steps(kind):
    """The chunk step's one causal pass (every token routed alone) writes
    the per-token step's cache bytes, every leaf, for each n_valid up to
    the chunk, on a slot in the middle of the pool."""
    paged, kv_quant = CACHES[kind]
    _, cfg = _cfgs(kv_quant)
    _, tq = _params()
    assert ST._projections_quantized(tq)
    chunk, slots, nb = 4, 3, 3 * (MAX_SEQ // BS) + 1
    one_pass = ST.make_prefill_chunk_step(cfg, mode=W8A16, chunk=chunk)
    per_token = ST.make_per_token_chunk_step(cfg, mode=W8A16, chunk=chunk)

    def cache():
        if not paged:
            return R.init_cache(cfg, slots, MAX_SEQ, device="cpu")
        c = R.init_paged_cache(cfg, slots, MAX_SEQ, BS, nb, device="cpu")
        c["block_tables"].copy_(torch.from_numpy(
            _tables(slots, nb, MAX_SEQ // BS, 2)))
        return c

    rng = np.random.default_rng(3)
    for n in range(1, chunk + 1):
        a, b = cache(), cache()
        toks = rng.integers(1, cfg.vocab, chunk).astype(np.int32)
        for start in (0, 5):
            one_pass(tq, toks, a, 1, start, n)
            per_token(tq, toks, b, 1, start, n)
        for key in a:
            assert torch.equal(a[key], b[key]), (n, key)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

_RUNS = {}


def _served(kv_quant):
    """The trace through the contiguous engine and through a paged one
    whose pool is below the worst case (9 usable blocks against 4 slots x
    3), with the batch-1 reference, served once per cache."""
    if kv_quant not in _RUNS:
        _, cfg = _cfgs(kv_quant)
        _, tq = _params()
        t = _trace(cfg.vocab)
        reqs = E.synthetic_requests(t.pop("n"), **t)
        kw = dict(mode=W8A16, num_slots=4, max_seq=MAX_SEQ,
                  prefill_chunk=4, device="cpu")
        contig = E.Engine(cfg, tq, **kw).serve(reqs)
        eng = E.Engine(cfg, tq, block_size=BS, num_blocks=10, **kw)
        paged = eng.serve(reqs)
        ref = E.reference_outputs(cfg, tq, reqs, mode=W8A16,
                                  max_seq=eng.max_seq, device="cpu")
        _RUNS[kv_quant] = reqs, contig, paged, ref
    return _RUNS[kv_quant]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_engine_equals_its_reference_paged_and_contiguous(kv_quant):
    """Eight requests through 4 slots with chunked prefill of 4 (each
    chunk one causal pass), on the contiguous cache and on a paged pool
    below the worst case with a shared prefix block: every token of both
    serves equal to the sequential batch-1 reference bit for bit, the
    prefix block shared, no block leaked."""
    _, contig, paged, ref = _served(kv_quant)
    assert contig.outputs() == ref
    assert paged.outputs() == ref
    assert all(r.status == "ok" and len(r.tokens) == GEN
               for r in paged.results)
    assert paged.shared_block_hits > 0
    assert paged.leaked_blocks == 0 and paged.peak_blocks_used <= 9


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_engine_matches_jax_paged_engine(kv_quant):
    """The port's paged engine and the JAX paged engine on the same
    weights and trace: greedy tokens equal up to the first step where
    either parts from the JAX sequential reference, and that step is one
    where the reference's top-2 logit gap is within LOGIT_ATOL."""
    jcfg, cfg = _cfgs(kv_quant)
    jq, _ = _params()
    _, _, paged, _ = _served(kv_quant)
    t = _trace(cfg.vocab)
    jreqs = JE.synthetic_requests(t.pop("n"), **t)
    jrep = JE.Engine(jcfg, jq, mode=JW8A16, num_slots=4, max_seq=MAX_SEQ,
                     prefill_chunk=4, block_size=BS,
                     num_blocks=10).serve(jreqs)
    want = jrep.outputs()
    jref, gaps = _jax_reference_with_margins(jcfg, jq, jreqs, MAX_SEQ)
    assert jrep.shared_block_hits == paged.shared_block_hits
    got = paged.outputs()
    assert got.keys() == want.keys()

    def first_difference(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    len(a))

    for rid, toks in want.items():
        assert len(got[rid]) == len(toks) == GEN
        first = min(first_difference(got[rid], toks),
                    first_difference(toks, jref[rid]))
        assert got[rid][:first] == toks[:first]
        if first < GEN:
            assert gaps[rid][first] <= LOGIT_ATOL, (rid, first, gaps[rid])


def test_warmup_binds_every_graph_a_paged_serve_replays():
    """``Engine.warmup`` binds the captured tick and every chunk graph;
    two serves then bind nothing anew and give the contiguous serve's
    tokens."""
    _, cfg = _cfgs()
    _, tq = _params()
    reqs, contig, _, _ = _served(False)
    eng = E.Engine(cfg, tq, mode=W8A16, num_slots=4, max_seq=MAX_SEQ,
                   prefill_chunk=4, block_size=BS, num_blocks=10,
                   device="cpu")
    steps = [eng.backend.slot_step(cfg, mode=W8A16, temperature=0.0)] + [
        eng.backend.chunk_step(cfg, mode=W8A16, chunk=c) for c in (1, 2, 4)]
    eng.warmup()
    bound = [s.captured.captures for s in steps]
    for _ in range(2):
        assert eng.serve(reqs).outputs() == contig.outputs()
    assert [s.captured.captures for s in steps] == bound


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_runs_the_moe_arch(capsys):
    """``--arch qwen2-moe-a2.7b --reduced`` through the serve CLI on the
    CPU, paged with a shared prefix: the streamed init, the service
    curve's forward (capacity over 8 tokens), the decode loop and the
    engine, every request equal to ``reference_outputs``."""
    res = serve.run(serve.parse_args([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--seq", "8",
        "--max-batch", "4", "--n-requests", "6", "--decode-tokens", "4",
        "--prompt-len", "8", "--gen-tokens", "4", "--prefill-chunk", "4",
        "--deadline-ms", "60000", "--block-size", "4", "--num-blocks", "9",
        "--shared-prefix-len", "4"]))
    assert res.code == 0
    out = capsys.readouterr().out
    assert f"[quant] {ARCH} weights" in out and "[decode]" in out
    assert res.cfg.family == "moe"
    rep = res.report
    assert rep.leaked_blocks == 0
    assert all(r.status == "ok" for r in rep.results)
    assert rep.outputs() == E.reference_outputs(
        res.cfg, res.params, res.requests, mode=res.mode,
        max_seq=res.engine.max_seq, device="cpu")
