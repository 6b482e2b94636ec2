"""The rest of the dense family — internlm2-20b, mistral-nemo-12b and
qwen1.5-32b — against the JAX package on the CPU at reduced size, with
the bf16 and the int8 KV cache, contiguous and paged.

``cfg.reduced()`` caps the KV heads at 2 and the query heads at 4, which
would give all three configs starcoder's shape.  Each keeps its own quirk
here through ``dataclasses.replace`` of the reduced config, the same
``ArchConfig`` values in both packages:
- internlm2: G = 6 query heads per KV head, q width = d_model;
- mistral-nemo: G = 4, with q width (n_heads * head_dim) below d_model;
- qwen1.5: 16 KV heads = 16 query heads (G = 1), which sends the
  reference's contiguous ``decode_step`` down its append-outside-scan
  branch (``n_kv_heads >= 16``, ``repro/models/transformer.py:219``)
  where the port writes in place and then attends.

The same weights go into both packages (the reference's ``init`` and
``quantize_tree``, copied through numpy by ``models/bridge.py``); inputs
come from numpy with a seed.  On the CPU the JAX decode attention is its
einsum fallback and the port's each kernel's plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs import get_config as jget_config
from repro.core.qlinear import W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import registry as JR
from repro.models import transformer as JT
from repro_torch import engine as E
from repro_torch.configs import get_config, list_archs
from repro_torch.core.qlinear import W8A16
from repro_torch.core.quant import QTensor, quantize_tree
from repro_torch.models import bridge
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.runtime import steps as ST

from test_torch_engine import _jax_reference_with_margins
from test_torch_forward import _check_logits
from test_torch_model import LOGIT_ATOL, to_numpy

# arch -> the fields that keep its quirk at reduced size
QUIRKS = {
    "internlm2-20b": dict(d_model=384, n_heads=12, n_kv_heads=2),
    "mistral-nemo-12b": dict(d_model=320, n_heads=8, n_kv_heads=2),
    "qwen1.5-32b": dict(d_model=512, n_heads=16, n_kv_heads=16),
}
ARCHS = list(QUIRKS)
# cache kind -> (paged, kv_quant)
CACHES = {"bf16": (False, False), "bf16_paged": (True, False),
          "int8": (False, True), "int8_paged": (True, True)}
BS, MAX_SEQ = 4, 16
# the engine traces: prompts whose first block is common to all requests
PROMPT, GEN, SHARED = 6, 5, 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, kv_quant=False):
    return tuple(dataclasses.replace(get(arch).reduced(), kv_quant=kv_quant,
                                     **QUIRKS[arch])
                 for get in (jget_config, get_config))


_PARAMS = {}


def _params(arch):
    """(jax int8 params, the port's copy of them), made once per arch."""
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        jq = jquantize_tree(JR.init(jax.random.PRNGKey(0), jcfg),
                            min_size=2048)
        _PARAMS[arch] = jq, bridge.params_from_numpy(to_numpy(jq),
                                                     device="cpu")
    return _PARAMS[arch]


def _tables(b, nb, mb, seed):
    """Each row's blocks, drawn without replacement from 1..nb-1."""
    perm = np.random.default_rng(seed).permutation(np.arange(1, nb))
    return perm[:b * mb].reshape(b, mb).astype(np.int32)


def _trace(vocab, n=8):
    return dict(n=n, rate_per_s=2000.0, vocab=vocab, prompt_len=PROMPT,
                max_new_tokens=GEN, shared_prefix_len=SHARED)


def _tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_tree_equal, a, b))
    if isinstance(a, QTensor):
        return (isinstance(b, QTensor) and torch.equal(a.values, b.values)
                and torch.equal(a.scale, b.scale)
                and a.scale.shape == b.scale.shape)
    return (not isinstance(b, QTensor) and a.dtype == b.dtype
            and torch.equal(a, b))


# ---------------------------------------------------------------------------
# configs and the streamed init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_arch_file_matches_reference(arch):
    """The port's arch file holds the JAX one's values field by field, at
    full width and reduced."""
    j, t = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    jcfg, cfg = _cfgs(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert t.family == "dense" and not t.kv_quant and R.supports_paging(t)


def test_the_four_dense_configs_are_registered():
    """The four dense configs, beside the MoE family's qwen2-moe-a2.7b
    (tests/test_torch_moe.py) and mixtral-8x22b (tests/test_torch_mixtral.py),
    the encdec family's whisper-medium (tests/test_torch_encdec.py), the
    ssm family's mamba2-1.3b (tests/test_torch_ssm.py), the hybrid
    family's recurrentgemma-9b (tests/test_torch_hybrid.py) and the vlm
    family's llama-3.2-vision-90b (tests/test_torch_vision.py), are the
    port's registered configs."""
    dense = ["starcoder2-3b", "internlm2-20b", "mistral-nemo-12b",
             "qwen1.5-32b"]
    assert all(get_config(a).family == "dense" for a in dense)
    assert list_archs() == sorted(dense + ["qwen2-moe-a2.7b",
                                           "mixtral-8x22b", "whisper-medium",
                                           "mamba2-1.3b",
                                           "recurrentgemma-9b",
                                           "llama-3.2-vision-90b"])


@pytest.mark.parametrize("arch", ARCHS + ["starcoder2-3b"])
def test_streamed_init_equals_quantize_tree(arch, monkeypatch):
    """``registry.init_quantized`` is ``quantize_tree(init(...),
    min_size=2048)`` from the same seed, bit for bit, every leaf of the
    same dtype and shape; its tables quantize a chunk of rows at a time
    (here 100 of 512), which changes no bit."""
    monkeypatch.setattr(T, "TABLE_ROW_CHUNK", 100)
    cfg = get_config(arch).reduced()
    whole = quantize_tree(R.init(torch.Generator().manual_seed(7), cfg,
                                 device="cpu"), min_size=2048)
    streamed = R.init_quantized(torch.Generator().manual_seed(7), cfg,
                                device="cpu")
    assert _tree_equal(whole, streamed)
    assert isinstance(streamed["layers"][1]["mlp"]["w_down"]["w"], QTensor)
    assert ("unembed" in streamed) == (not cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """The full-sequence forward under W8A16 against the JAX forward under
    jax.jit, (2, 12) tokens: logits within LOGIT_ATOL, greedy tokens equal
    where the reference's top-2 gap is outside it."""
    jcfg, cfg = _cfgs(arch)
    jq, tq = _params(arch)
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (2, 12)).astype(
        np.int32)
    want = np.asarray(jax.jit(lambda p, t: JR.apply_forward(
        p, jcfg, {"tokens": t}, mode=JW8A16, remat=False))(
            jq, jnp.asarray(toks)))
    got = ST.make_prefill_step(cfg, mode=W8A16)(
        tq, {"tokens": torch.from_numpy(toks)})
    _check_logits(got.numpy(), want, LOGIT_ATOL)


@pytest.mark.parametrize("kind", list(CACHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, kind):
    """Eight W8A16 decode steps, four rows at ragged per-row positions, on
    the cache ``kind`` (paged: each row on shuffled physical blocks): the
    logits within LOGIT_ATOL of the JAX decode_step's, greedy tokens equal
    where the reference's top-2 gap is outside it, and both caches
    written at the same places."""
    paged, kv_quant = CACHES[kind]
    jcfg, cfg = _cfgs(arch, kv_quant)
    jq, tq = _params(arch)
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
    if arch == "qwen1.5-32b" and not paged:     # the reference's append form
        assert jcfg.n_kv_heads >= 16 and jcfg.window is None
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, cfg.vocab, (steps, b, 1)).astype(np.int32)
    start = np.array([0, 3, 7, 1], np.int32)
    jdecode = jax.jit(lambda p, t, c, i: JT.decode_step(p, t, c, i, jcfg,
                                                         mode=JW8A16))
    decode = ST.make_decode_step(cfg, mode=W8A16)
    for s in range(steps):
        idx = start + s
        jl, jcache = jdecode(jq, jnp.asarray(tokens[s]), jcache,
                             jnp.asarray(idx))
        tl, tcache = decode(tq, {"tokens": torch.from_numpy(tokens[s]),
                                 "cache_index": torch.from_numpy(idx)},
                            tcache)
        assert tl.dtype == torch.float32
        _check_logits(tl.numpy(), np.asarray(jl), LOGIT_ATOL)
    # written at the same places: a scale (int8) or a value (bf16) is
    # nonzero exactly where a token was written
    for name in (("k_scale", "v_scale") if kv_quant else ("k", "v")):
        got = tcache[name].float().numpy() != 0
        want = np.asarray(jcache[name]).astype(np.float32) != 0
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_equals_contiguous_bitwise(arch, kv_quant):
    """The same history decoded into a paged cache and into contiguous
    rows: bit-identical logits at every step (one token, then a causal
    pass of three, as the chunk step runs), and the gathered paged rows
    equal the contiguous rows byte for byte up to each frontier."""
    _, cfg = _cfgs(arch, kv_quant)
    _, tq = _params(arch)
    b, nb = 3, 3 * (MAX_SEQ // BS) + 2
    tables = _tables(b, nb, MAX_SEQ // BS, 1)
    paged = R.init_paged_cache(cfg, b, MAX_SEQ, BS, nb, device="cpu")
    paged["block_tables"].copy_(torch.from_numpy(tables))
    contig = R.init_cache(cfg, b, MAX_SEQ, device="cpu")
    rng = np.random.default_rng(1)
    start = torch.tensor([0, 5, 2], dtype=torch.int32)
    pos = start
    for s in (1, 1, 3, 1, 3):
        toks = torch.from_numpy(rng.integers(1, cfg.vocab, (b, s)).astype(
            np.int32))
        lp, _ = T.decode_step(tq, toks, paged, pos, cfg, mode=W8A16,
                              causal=True)
        lc, _ = T.decode_step(tq, toks, contig, pos, cfg, mode=W8A16,
                              causal=True)
        assert torch.equal(lp, lc)
        pos = pos + s
    for key in contig:
        got = L.paged_gather(paged[key][1], paged["block_tables"])
        for r in range(b):
            n = int(pos[r])
            assert torch.equal(got[r, :n], contig[key][1][r, :n])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

_RUNS = {}


def _served(arch, kv_quant):
    """The trace through the contiguous engine and through a paged one
    whose pool is below the worst case (9 usable blocks against 4 slots x
    3), with the batch-1 reference, served once per (arch, cache)."""
    key = (arch, kv_quant)
    if key not in _RUNS:
        _, cfg = _cfgs(arch, kv_quant)
        _, tq = _params(arch)
        t = _trace(cfg.vocab)
        reqs = E.synthetic_requests(t.pop("n"), **t)
        kw = dict(mode=W8A16, num_slots=4, max_seq=MAX_SEQ,
                  prefill_chunk=4, device="cpu")
        contig = E.Engine(cfg, tq, **kw).serve(reqs)
        eng = E.Engine(cfg, tq, block_size=BS, num_blocks=10, **kw)
        paged = eng.serve(reqs)
        ref = E.reference_outputs(cfg, tq, reqs, mode=W8A16,
                                  max_seq=eng.max_seq, device="cpu")
        _RUNS[key] = reqs, contig, paged, ref
    return _RUNS[key]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_equals_its_reference_paged_and_contiguous(arch, kv_quant):
    """Eight requests through 4 slots with chunked prefill of 4, on the
    contiguous cache and on a paged pool below the worst case with a
    shared prefix block: every token of both serves equal to the
    sequential batch-1 reference bit for bit, the prefix block shared,
    no block leaked, and the resident KV bytes those of the cache's own
    leaves (bf16: two of (L, NB, bs, KV, hd) bf16; int8: int8 values and
    f32 scales)."""
    _, cfg = _cfgs(arch, kv_quant)
    _, contig, paged, ref = _served(arch, kv_quant)
    assert contig.outputs() == ref
    assert paged.outputs() == ref
    assert all(r.status == "ok" and len(r.tokens) == GEN
               for r in paged.results)
    assert paged.shared_block_hits > 0
    assert paged.prefill_tokens_skipped == paged.shared_block_hits * BS
    assert paged.leaked_blocks == 0 and paged.peak_blocks_used <= 9
    per_slot = cfg.n_layers * cfg.n_kv_heads * (
        cfg.head_dim + 4 if kv_quant else 2 * cfg.head_dim)
    assert paged.kv_hbm_bytes == 2 * 10 * BS * per_slot + 4 * 4 * (
        MAX_SEQ // BS)
    assert contig.kv_hbm_bytes == 2 * 4 * MAX_SEQ * per_slot


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_paged_engine(arch, kv_quant):
    """The port's paged engine and the JAX paged engine on the same
    weights and trace: greedy tokens equal up to the first step where
    either parts from the JAX sequential reference, and that step is one
    where the reference's top-2 logit gap is within LOGIT_ATOL; after it
    the two decode different inputs.  Both share the same prefix blocks.

    No cap on how many requests part: at this size a reference gap falls
    within LOGIT_ATOL at about one generated token in five, and the JAX
    engine itself parts from its own reference at such steps (its CPU
    einsums are not batch-invariant), so most requests meet one."""
    jcfg, cfg = _cfgs(arch, kv_quant)
    jq, _ = _params(arch)
    _, _, paged, _ = _served(arch, kv_quant)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_warmup_binds_every_graph_a_paged_bf16_serve_replays(arch):
    """On the paged bf16 cache, ``Engine.warmup`` binds the captured tick
    and every chunk graph; two serves then bind nothing anew and give the
    same tokens as the un-warmed contiguous serve."""
    _, cfg = _cfgs(arch)
    _, tq = _params(arch)
    reqs, contig, _, _ = _served(arch, False)
    eng = E.Engine(cfg, tq, mode=W8A16, num_slots=4, max_seq=MAX_SEQ,
                   prefill_chunk=4, block_size=BS, num_blocks=10,
                   device="cpu")
    steps = [eng.backend.slot_step(cfg, mode=W8A16, temperature=0.0)] + [
        eng.backend.chunk_step(cfg, mode=W8A16, chunk=c) for c in (1, 2, 4)]

    def captures():
        return [s.captured.captures for s in steps]

    eng.warmup()
    bound = captures()
    for _ in range(2):
        assert eng.serve(reqs).outputs() == contig.outputs()
    assert captures() == bound
