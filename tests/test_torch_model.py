"""The port's dense model (starcoder2, int8 weights, int8 KV cache) against
the JAX package, on the CPU at reduced size.

The same weights go into both packages: the reference's ``init`` and
``quantize_tree`` output, copied through numpy by ``models/bridge.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.qlinear import W8A16 as JW8A16
from repro.core.quant import QTensor as JQTensor
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import registry as JR
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.core.qlinear import W8A16
from repro_torch.core.quant import QTensor, quantize_tree
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.runtime import steps as ST

# Logit tolerance against the JAX CPU path.  Stage by stage on the same
# inputs the port agrees with the reference exactly (embedding, norms) or
# to f32 rounding (MLP, LM head), and its attention output to one bf16 ulp:
# the reference's CPU decode attention is the einsum fallback
# (layers.py:403-446), which rounds q, the int8 cache and the v-scaled
# probabilities to bf16 where the port (as the TPU kernel) keeps f32.
# Those one-ulp (2^-8 relative) disagreements in the bf16 residual stream
# move the logits, whose range at this size is about +-12, by up to ~0.05
# over eight steps.  0.1 (under 1% of that range) bounds them, while a
# wrong mask, scale, position or head mapping moves logits by O(1).
LOGIT_ATOL = 0.1


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    jcfg = dataclasses.replace(jget_config("starcoder2-3b").reduced(),
                               kv_quant=True)
    tcfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                               kv_quant=True)
    return jcfg, tcfg


def to_numpy(tree):
    """The reference's params as the bridge takes them: numpy leaves, each
    QTensor as a (values, scale) pair."""
    return jax.tree_util.tree_map(
        lambda x: ((np.asarray(x.values), np.asarray(x.scale))
                   if isinstance(x, JQTensor) else np.asarray(x)),
        tree, is_leaf=lambda x: isinstance(x, JQTensor))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jfp = JR.init(jax.random.PRNGKey(0), jcfg)
    jq = jquantize_tree(jfp, min_size=2048)
    tq = bridge.params_from_numpy(to_numpy(jq), device="cpu")
    return jcfg, tcfg, jfp, jq, tq


def test_config_matches_reference():
    for name in ("starcoder2-3b",):
        j, t = jget_config(name), get_config(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(
            t.reduced())
        assert j.param_count() == t.param_count()


def test_bridge_copies_every_leaf(setup):
    jcfg, _, _, jq, tq = setup
    assert len(tq["layers"]) == jcfg.n_layers
    for i, lp in enumerate(tq["layers"]):
        jw = jq["layers"]["attn"]["wq"]["w"]
        tw = lp["attn"]["wq"]["w"]
        assert isinstance(tw, QTensor)
        np.testing.assert_array_equal(tw.values.numpy(),
                                      np.asarray(jw.values[i]))
        np.testing.assert_array_equal(tw.scale.numpy(),
                                      np.asarray(jw.scale[i]))
        np.testing.assert_array_equal(
            lp["ln_attn"]["scale"].numpy(),
            np.asarray(jq["layers"]["ln_attn"]["scale"][i]))
    assert isinstance(tq["embed"]["table"], QTensor)


def test_quantize_tree_bitwise_and_same_leaves(setup):
    """The port's quantize_tree of the same f32 weights quantizes the same
    leaves, bitwise, as the reference's (min_size=2048, as the bench)."""
    _, _, jfp, _, tq = setup
    tfp = bridge.params_from_numpy(to_numpy(jfp), device="cpu")
    mine = quantize_tree(tfp, min_size=2048)

    def leaves(node, path=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, f"{path}.{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                yield from leaves(v, f"{path}.{i}")
        else:
            yield path, node

    a, b = dict(leaves(mine)), dict(leaves(tq))
    assert a.keys() == b.keys()
    n_q = 0
    for path, x in a.items():
        y = b[path]
        assert isinstance(x, QTensor) == isinstance(y, QTensor), path
        if isinstance(x, QTensor):
            n_q += 1
            assert torch.equal(x.values, y.values), path
            assert torch.equal(x.scale, y.scale), path
        else:
            assert torch.equal(x, y), path
    assert n_q == 1 + 6 * len(tq["layers"])      # table + 6 per layer


def test_decode_step_matches_reference(setup):
    """Eight decode steps, four rows at ragged per-row positions: the
    port's logits track the reference's within LOGIT_ATOL at every step,
    and their greedy tokens agree wherever the reference's top-2 gap is
    outside that tolerance."""
    jcfg, tcfg, _, jq, tq = setup
    b, smax, steps = 4, 16, 8
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, jcfg.vocab, (steps, b, 1)).astype(np.int32)
    start = np.array([0, 3, 7, 1], np.int32)
    jdecode = jax.jit(lambda p, t, c, i: JT.decode_step(p, t, c, i, jcfg,
                                                         mode=JW8A16))
    jcache = JR.init_cache(jcfg, b, smax)
    tcache = R.init_cache(tcfg, b, smax, device="cpu")
    worst = 0.0
    for s in range(steps):
        idx = start + s
        jl, jcache = jdecode(jq, jnp.asarray(tokens[s]), jcache,
                             jnp.asarray(idx))
        tl, tcache = ST.make_decode_step(tcfg, mode=W8A16)(
            tq, {"tokens": torch.from_numpy(tokens[s]),
                 "cache_index": torch.from_numpy(idx)}, tcache)
        jl = np.asarray(jl)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        diff = np.abs(tl.numpy() - jl)
        worst = max(worst, float(diff.max()))
        top2 = np.sort(jl[:, -1], axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > LOGIT_ATOL
        np.testing.assert_array_equal(
            tl.numpy()[:, -1].argmax(-1)[clear], jl[:, -1].argmax(-1)[clear])
    assert worst <= LOGIT_ATOL, worst


def test_decode_rows_match_batch_one_bitwise(setup):
    """A row of a per-row (vector-index) batch step is bit-identical to the
    same row decoded alone with a lockstep (int) index — the property the
    engine's bit parity with its sequential reference rests on."""
    _, tcfg, _, _, tq = setup
    decode = ST.make_decode_step(tcfg, mode=W8A16)
    idx = np.array([2, 0, 5], np.int32)
    toks = np.array([[7], [100], [3]], np.int32)
    cache = R.init_cache(tcfg, 3, 16, device="cpu")
    # give the rows some history first
    for s in range(6):
        decode(tq, {"tokens": torch.from_numpy(toks + s),
                    "cache_index": torch.from_numpy(np.minimum(idx, s))},
               cache)
    rows = [{k: v[:, r:r + 1].clone() for k, v in cache.items()}
            for r in range(3)]
    full, cache = decode(tq, {"tokens": torch.from_numpy(toks),
                              "cache_index": torch.from_numpy(idx)}, cache)
    for r in range(3):
        one, rows[r] = decode(tq, {"tokens": torch.from_numpy(toks[r:r + 1]),
                                   "cache_index": int(idx[r])}, rows[r])
        assert torch.equal(one[0], full[r])
        for k in cache:
            assert torch.equal(rows[r][k][:, 0], cache[k][:, r])


def test_unported_paths_name_their_roadmap_item():
    """The sharded executor is not ported yet: asking for it raises,
    naming its ROADMAP item."""
    from repro_torch import engine as E

    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 14"):
        E.ShardedExecutor()
