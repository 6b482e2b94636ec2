"""The port's vlm family (llama-3.2-vision-90b) against the JAX package, on
the CPU at reduced size (d 128, 4 query heads over 2 KV heads of 32,
vocab 512 untied, a cross layer every 2nd layer over 8 patches): the
2-layer ``reduced()`` (one group) and a 5-layer variant of it (two groups
and one leftover plain layer).

The same weights go into both packages (the reference's ``init`` and
``quantize_tree``, copied through numpy by ``models/bridge.py``, which
flattens the reference's twice-stacked groups into one layer list).  The
reference initialises every ``x_gate`` to zero, which would hide the
cross-attention from every logit: here each group's gate is set nonzero
(GATES) in the reference's tree before it is quantized and copied, so
both packages carry the same nonzero gates.  Patches and tokens come
from numpy with a seed.  On the CPU the JAX attention is its chunked
einsum path and the port's each kernel's plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core.qlinear import FP as JFP
from repro.core.qlinear import W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import registry as JR
from repro.models import vision as JVis
from repro.runtime import steps as JST
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.qlinear import FP, W8A16
from repro_torch.core.quant import QTensor, quantize_tree
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.models import vision as Vis
from repro_torch.runtime import steps as ST

from test_torch_forward import _check_logits
from test_torch_model import LOGIT_ATOL, to_numpy

ARCH = "llama-3.2-vision-90b"
MODES = {"fp": (FP, JFP), "w8a16": (W8A16, JW8A16)}
# reduced() (2 layers, one group) and 5 layers (two groups, one leftover)
DEPTHS = (2, 5)
# each group's tanh gate, set in place of the reference's zero init
GATES = (0.5, -0.75)
# Cross k/v tolerance (bf16 values up to about 4.5: unnormalised gaussian
# patches through a 1/sqrt(d) projection): both packages sum each
# projection in f32 and round to bf16, in different orders, so a value may
# land one bf16 ulp apart (0.03125 in [4, 8)).  A wrong weight, group or
# pad moves values by O(1).
XKV_ATOL = 0.03125
MAX_SEQ = 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(n_layers=2):
    """(JAX config, the port's) at reduced size and ``n_layers``."""
    return (dataclasses.replace(jget_config(ARCH).reduced(),
                                n_layers=n_layers),
            dataclasses.replace(get_config(ARCH).reduced(),
                                n_layers=n_layers))


def gated_params(jcfg):
    """The reference's f32 params with every group's gate set from GATES,
    and their quantized tree, each with the port's bridged copy:
    {mode: (JAX params, port params)}."""
    jfp = JR.init(jax.random.PRNGKey(0), jcfg)
    g = jfp["groups"]["xattn"]["x_gate"].shape[0]
    jfp["groups"]["xattn"]["x_gate"] = jnp.asarray(GATES[:g], jnp.float32)
    jq = jquantize_tree(jfp, min_size=2048)
    return {"fp": (jfp, bridge.params_from_numpy(to_numpy(jfp),
                                                 device="cpu")),
            "w8a16": (jq, bridge.params_from_numpy(to_numpy(jq),
                                                   device="cpu"))}


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda n: f"L{n}")
def setup(request):
    """(jcfg, cfg, {mode: (JAX params, the port's bridged copy)})."""
    jcfg, cfg = cfgs(request.param)
    return jcfg, cfg, gated_params(jcfg)


def patches(seed, b, p, d, n_valid=None):
    """Seeded patch embeddings as bf16 (zero past ``n_valid``): the JAX
    array and the port's tensor."""
    x = np.random.default_rng(seed).standard_normal((b, p, d)).astype(
        np.float32)
    if n_valid is not None:
        x[:, n_valid:] = 0.0
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# config, input specs, registry, params
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    j, t = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    """The vlm cell's inputs: the tokens (and labels or cache index) and
    the stub patch embeddings (b, n_patches, d_model) bf16, as the
    reference's ``ShapeDtypeStruct`` stand-ins."""
    for j, t in ((jget_config(ARCH), get_config(ARCH)), cfgs()):
        mine = t.input_specs(ShapeSpec("s", 32, 4, kind))
        ref = j.input_specs(JShapeSpec("s", 32, 4, kind))
        assert mine.keys() == ref.keys() and "vision_embeds" in mine
        for name, (shape, dtype) in mine.items():
            assert shape == ref[name].shape
            assert str(dtype).split(".")[-1] == str(ref[name].dtype)
        assert mine["vision_embeds"][0] == (4, t.n_patches, t.d_model)


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_registry_answers_as_the_reference(n_layers):
    """Paging, priming and the source length as the reference answers;
    no speculation; the one-pass chunk; the cross leaves' shapes and
    dtypes are the reference's, and the self cache holds the reference's
    grouped and leftover layers in one stack."""
    jcfg, cfg = cfgs(n_layers)
    assert R.needs_prime(cfg) and JR.needs_prime(jcfg)
    assert R.source_len(cfg) == JR.source_len(jcfg) == 8
    assert R.source_shape(cfg) == JR.source_shape(jcfg) == (8, 128)
    assert R.supports_paging(cfg) == JR.supports_paging(jcfg) is True
    assert R.supports_speculation(cfg) == JR.supports_speculation(jcfg) \
        is False
    assert R.decodes_chunk_in_one_pass(cfg)
    for paged in (False, True):
        if paged:
            cache = R.init_paged_cache(cfg, 2, 8, 4, 5, device="cpu")
            jcache = JR.init_paged_cache(jcfg, 2, 8, 4, 5)
            assert R.paged_block_axes(cfg, cache) == {"k": 1, "v": 1}
        else:
            cache = R.init_cache(cfg, 2, 8, device="cpu")
            jcache = JR.init_cache(jcfg, 2, 8)
        for k in ("xk", "xv", "xlen") + (("block_tables",) if paged else ()):
            assert tuple(cache[k].shape) == jcache[k].shape, k
            assert str(cache[k].dtype).split(".")[-1] == \
                str(jcache[k].dtype)
        jaxes = JR.cache_batch_axes(jcfg, jcache)
        axes = R.cache_batch_axes(cfg, cache)
        assert {k: axes[k] for k in ("xk", "xv", "xlen")} == \
            {k: jaxes[k] for k in ("xk", "xv", "xlen")}
        # the self cache: the groups' (G, E) layers, then the leftover
        n_self = int(np.prod(jcache["k"].shape[:2])) + (
            jcache["lo_k"].shape[0] if "lo_k" in jcache else 0)
        assert cache["k"].shape == (n_self,) + jcache["k"].shape[2:]
        assert cache["k"].dtype == cache["v"].dtype == torch.bfloat16
        assert axes["k"] == axes["v"] == 1


def test_bridge_flattens_the_groups(setup):
    """The reference's twice-stacked groups come out as one flat layer
    list in order — each group's plain layers, its cross layer, then the
    leftover layers — every leaf the reference's bit for bit, the cross
    layers at ``vision.is_cross`` with their nonzero gates."""
    jcfg, cfg, params = setup
    jq, tq = params["w8a16"]
    layers = tq["layers"]
    assert len(layers) == cfg.n_layers and "groups" not in tq
    cross = [i for i, lp in enumerate(layers) if "xattn" in lp]
    assert cross == [i for i in range(cfg.n_layers) if Vis.is_cross(cfg, i)]
    assert len(cross) == Vis.n_groups(cfg) == cfg.n_layers // 2
    assert [float(layers[i]["x_gate"]) for i in cross] == \
        list(GATES[:len(cross)])
    assert layers[cross[0]]["x_gate"].dtype == torch.float32
    e = cfg.xattn_every
    for i, lp in enumerate(layers):
        g, j = divmod(i, e)
        if g < Vis.n_groups(cfg):
            src = (jq["groups"]["xattn"] if j == e - 1 else
                   jax.tree_util.tree_map(lambda a: a[:, j],
                                          jq["groups"]["plain"]))
            src = jax.tree_util.tree_map(lambda a: a[g], src)
        else:
            src = jax.tree_util.tree_map(
                lambda a: a[i - Vis.n_groups(cfg) * e], jq["leftover"])
        w = lp["mlp"]["w_down"]["w"]
        assert isinstance(w, QTensor)
        want = src["mlp"]["w_down"]["w"]
        assert np.array_equal(w.values.numpy(), np.asarray(want.values))
        assert np.array_equal(w.scale.numpy(), np.asarray(want.scale))
        if "xattn" in lp:
            assert np.array_equal(lp["xattn"]["wk"]["w"].values.numpy(),
                                  np.asarray(src["xattn"]["wk"]["w"].values))
            assert np.array_equal(lp["ln_x"]["scale"].numpy(),
                                  np.asarray(src["ln_x"]["scale"]))
    assert isinstance(tq["unembed"]["table"], QTensor)


def test_init_quantized_is_quantize_tree_of_init():
    """The streamed init quantizes the leaves the whole-tree quantizer
    would, bit for bit, from the same draws; the gates start at zero and
    stay f32."""
    _, cfg = cfgs(5)
    whole = quantize_tree(Vis.init(torch.Generator().manual_seed(3), cfg,
                                   device="cpu"), min_size=2048)
    streamed = R.init_quantized(torch.Generator().manual_seed(3), cfg,
                                min_size=2048, device="cpu")

    def leaves(node):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from leaves(node[k])
        elif isinstance(node, list):
            for v in node:
                yield from leaves(v)
        elif isinstance(node, QTensor):
            yield node.values
            yield node.scale
        else:
            yield node

    a, b = list(leaves(whole)), list(leaves(streamed))
    assert len(a) == len(b)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    gates = [lp["x_gate"] for lp in streamed["layers"] if "x_gate" in lp]
    assert len(gates) == 2 and all(
        g.dtype == torch.float32 and float(g) == 0.0 for g in gates)
    assert isinstance(streamed["layers"][1]["xattn"]["wv"]["w"], QTensor)


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_reference(setup, mode):
    """The full-sequence forward (the service curve's prefill): (2, 8)
    tokens against two rows of patches, logits within LOGIT_ATOL of the
    jitted reference's and greedy tokens equal wherever the reference's
    top-2 gap is outside it."""
    jcfg, cfg, params = setup
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 8),
                                             dtype=np.int32)
    jx, tx = patches(4, 2, cfg.n_patches, cfg.d_model)
    want = np.asarray(jax.jit(lambda p, t, e: JR.apply_forward(
        p, jcfg, {"tokens": t, "vision_embeds": e}, mode=jm,
        remat=False))(jp, jnp.asarray(toks), jx))
    got = ST.make_prefill_step(cfg, mode=tm)(
        tp, {"tokens": torch.from_numpy(toks), "vision_embeds": tx})
    _check_logits(got.numpy(), want, LOGIT_ATOL)


def test_the_patches_reach_the_logits(setup):
    """With nonzero gates two sources give other logits, in the forward
    and in a primed decode step; with every gate at zero (the reference's
    init) they give the same."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 6), dtype=np.int32))
    srcs = [patches(40 + i, 1, cfg.n_patches, cfg.d_model)[1]
            for i in range(2)]
    closed = dict(tp, layers=[dict(lp, x_gate=torch.zeros(()))
                              if "xattn" in lp else lp
                              for lp in tp["layers"]])
    for p, differ in ((tp, True), (closed, False)):
        fwd = [Vis.forward(p, toks, s, cfg, mode=W8A16) for s in srcs]
        steps = []
        for s in srcs:
            cache = R.init_cache(cfg, 1, MAX_SEQ, device="cpu")
            Vis.prime_cache(p, cache, s, cfg, mode=W8A16)
            steps.append(Vis.decode_step(p, toks[:, :1], cache, 0, cfg,
                                         mode=W8A16)[0])
        assert (not torch.equal(*fwd)) == differ
        assert (not torch.equal(*steps)) == differ


@pytest.mark.parametrize("n_valid", [8, 5])
@pytest.mark.parametrize("mode", list(MODES))
def test_prime_slot_matches_reference(setup, mode, n_valid):
    """One request's prime: every group's pre-projected cross k/v within
    XKV_ATOL of the reference's, zero where the patches are padding, and
    the row's xlen frontier."""
    jcfg, cfg, params = setup
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    jx, tx = patches(2, 1, cfg.n_patches, cfg.d_model, n_valid)
    want = JR.prime_slot(jcfg, jp, jx, jnp.asarray(n_valid, jnp.int32),
                         mode=jm)
    got = R.prime_slot(cfg, tp, tx, n_valid, mode=tm)
    assert set(got) == set(want) == {"xk", "xv", "xlen"}
    for k in ("xk", "xv"):
        assert tuple(got[k].shape) == tuple(want[k].shape) == (
            Vis.n_groups(cfg), 1, cfg.n_patches, cfg.n_kv_heads,
            cfg.head_dim)
        assert float(np.abs(_np(got[k]) - _np(want[k])).max()) <= XKV_ATOL
        assert not got[k][:, :, n_valid:].any()
    assert got["xlen"].dtype == torch.int32
    assert got["xlen"].tolist() == np.asarray(want["xlen"]).tolist() == \
        [n_valid]


def _lockstep_caches(jcfg, cfg, jp, tp, jm, tm, b):
    """A lockstep cache of each package, primed batchwide over b rows of
    patches (every frontier at every patch)."""
    jx, tx = patches(6, b, cfg.n_patches, cfg.d_model)
    jcache = JVis.prime_cache(jp, JR.init_cache(jcfg, b, MAX_SEQ), jx, jcfg,
                              mode=jm)
    cache = R.init_cache(cfg, b, MAX_SEQ, device="cpu")
    assert Vis.prime_cache(tp, cache, tx, cfg, mode=tm) is cache
    for k in ("xk", "xv"):
        assert float(np.abs(_np(cache[k]) - _np(jcache[k])).max()) <= \
            XKV_ATOL
    assert cache["xlen"].tolist() == np.asarray(jcache["xlen"]).tolist() \
        == [cfg.n_patches] * b
    assert not cache["k"].any() and not cache["v"].any()
    return jcache, cache


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_step_matches_reference_lockstep(setup, mode):
    """The lockstep decode path (an int index, the decode loop's): two
    rows primed batchwide, a 3-token prompt in one call and then five
    one-token steps, logits within LOGIT_ATOL of the reference's at every
    step and greedy tokens equal where its top-2 gap is outside it."""
    jcfg, cfg, params = setup
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    jcache, cache = _lockstep_caches(jcfg, cfg, jp, tp, jm, tm, 2)
    jdecode = jax.jit(JST.make_decode_step(jcfg, mode=jm))
    decode = ST.make_decode_step(cfg, mode=tm)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 8),
                                             dtype=np.int32)
    pos = 0
    for n in (3, 1, 1, 1, 1, 1):
        tok = toks[:, pos:pos + n]
        want, jcache = jdecode(jp, {"tokens": jnp.asarray(tok),
                                    "cache_index": jnp.asarray(
                                        pos, jnp.int32)}, jcache)
        got, cache = decode(tp, {"tokens": torch.from_numpy(tok),
                                 "cache_index": pos}, cache)
        _check_logits(got.numpy(), np.asarray(want), LOGIT_ATOL)
        pos += n


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_step_matches_reference_per_row(setup, mode, paged):
    """The per-row decode path of the slot engine: two slots primed with
    sources of 8 and 5 real patches (xlen < n_patches on row 1), six
    steps at per-row positions (B,) with the same tokens fed to both
    packages; logits within LOGIT_ATOL at every step, greedy tokens equal
    where the reference's top-2 gap is outside it.  ``paged`` runs the
    port on the paged bf16 cache (blocks of 4) against the JAX
    contiguous cache."""
    jcfg, cfg, params = setup
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    jprime = jax.jit(JST.make_prime_step(jcfg, mode=jm))
    jdecode = jax.jit(JST.make_decode_step(jcfg, mode=jm))
    prime = ST.make_prime_step(cfg, mode=tm)
    decode = ST.make_decode_step(cfg, mode=tm)
    jcache = JR.init_cache(jcfg, 2, MAX_SEQ)
    if paged:
        cache = R.init_paged_cache(cfg, 2, MAX_SEQ, 4, 9, device="cpu")
        cache["block_tables"].copy_(torch.arange(1, 9, dtype=torch.int32)
                                    .reshape(2, 4))
    else:
        cache = R.init_cache(cfg, 2, MAX_SEQ, device="cpu")
    for sid, n in ((0, 8), (1, 5)):
        jx, tx = patches(10 + sid, 1, cfg.n_patches, cfg.d_model, n)
        jcache = jprime(jp, jx, jcache, jnp.asarray(sid, jnp.int32),
                        jnp.asarray(n, jnp.int32))
        cache = prime(tp, tx, cache, sid, n)
    assert cache["xlen"].tolist() == [8, 5]
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (6, 2),
                                             dtype=np.int32)
    idx = np.array([0, 3], np.int32)
    for t in range(6):
        tok = toks[t][:, None]
        want, jcache = jdecode(jp, {"tokens": jnp.asarray(tok),
                                    "cache_index": jnp.asarray(idx + t)},
                               jcache)
        got, cache = decode(tp, {"tokens": torch.from_numpy(tok),
                                 "cache_index": torch.from_numpy(idx + t)},
                            cache)
        _check_logits(got.numpy(), np.asarray(want), LOGIT_ATOL)


def test_decode_rows_match_batch_one_bitwise(setup):
    """Each row of a per-row step over three primed slots (frontiers 8,
    6 and 3) equals that row stepped alone at batch 1 with an int index,
    bit for bit: its logits and every cache leaf it writes."""
    _, cfg, params = setup
    _, tq = params["w8a16"]
    prime = ST.make_prime_step(cfg, mode=W8A16)
    decode = ST.make_decode_step(cfg, mode=W8A16)
    cache = R.init_cache(cfg, 3, MAX_SEQ, device="cpu")
    for sid, n in enumerate((8, 6, 3)):
        prime(tq, patches(20 + sid, 1, cfg.n_patches, cfg.d_model, n)[1],
              cache, sid, n)
    toks = np.array([[5], [9], [2]], np.int32)
    idx = np.array([4, 0, 2], np.int32)
    for s in range(4):
        decode(tq, {"tokens": torch.from_numpy(toks + s),
                    "cache_index": torch.from_numpy(np.minimum(idx, s))},
               cache)
    axes = R.cache_batch_axes(cfg, cache)
    rows = [{k: v.narrow(axes[k], r, 1).clone() for k, v in cache.items()}
            for r in range(3)]
    full, cache = decode(tq, {"tokens": torch.from_numpy(toks),
                              "cache_index": torch.from_numpy(idx)}, cache)
    for r in range(3):
        one, rows[r] = decode(tq, {"tokens": torch.from_numpy(toks[r:r + 1]),
                                   "cache_index": int(idx[r])}, rows[r])
        assert torch.equal(one[0], full[r])
        for k in cache:
            assert torch.equal(rows[r][k], cache[k].narrow(axes[k], r, 1)), k


# ---------------------------------------------------------------------------
# the prime step and the chunk step
# ---------------------------------------------------------------------------

def test_captured_prime_step_equals_the_eager_one(setup):
    """The captured prime step's static-buffer code (run eagerly on the
    CPU) writes what the eager step writes, into the named row only, for
    every slot through one binding."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    eager = ST.make_prime_step(cfg, mode=W8A16)
    graphed = ST.jit_prime_step(eager)
    a = R.init_cache(cfg, 4, MAX_SEQ, device="cpu")
    b = R.init_cache(cfg, 4, MAX_SEQ, device="cpu")
    for sid, n in ((2, 8), (0, 3)):
        tx = patches(30 + sid, 1, cfg.n_patches, cfg.d_model, n)[1]
        eager(tp, tx, a, sid, n)
        graphed(tp, tx, b, sid, n)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert graphed.captured.captures == 1
    assert a["xlen"].tolist() == [3, 8, 8, 8]
    assert not a["xk"][:, 1].any() and not a["xk"][:, 3].any()
    assert a["xk"][:, 2].any() and not a["xk"][:, 0, 3:].any()


@pytest.mark.parametrize("paged", [False, True])
def test_chunk_pass_equals_the_per_token_steps(setup, paged):
    """The one-pass W8A16 chunk step of a primed slot (its cross rows read
    at ``slots = sid``) writes the bytes of the per-token chunk step,
    every leaf, for every chunk length."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    prime = ST.make_prime_step(cfg, mode=W8A16)

    def fresh():
        if paged:
            c = R.init_paged_cache(cfg, 3, MAX_SEQ, 4, 13, device="cpu")
            c["block_tables"].copy_(torch.arange(1, 13, dtype=torch.int32)
                                    .reshape(3, 4))
        else:
            c = R.init_cache(cfg, 3, MAX_SEQ, device="cpu")
        for sid, n in ((0, 8), (1, 6), (2, 3)):
            prime(tp, patches(50 + sid, 1, cfg.n_patches, cfg.d_model,
                              n)[1], c, sid, n)
        return c

    for n in range(1, 5):
        one = ST.make_prefill_chunk_step(cfg, mode=W8A16, chunk=4)
        ref = ST.make_per_token_chunk_step(cfg, mode=W8A16, chunk=4)
        toks = [3, 7, 11, 2]
        a, b = fresh(), fresh()
        one(tp, toks, a, 1, 2, n)
        ref(tp, toks, b, 1, 2, n)
        for k in a:
            assert torch.equal(a[k], b[k]), (n, k)
        assert a["k"][:, 5 if paged else 1].any()
