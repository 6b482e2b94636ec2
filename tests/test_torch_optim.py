"""The port's optimizers (``repro_torch/optim``) against the JAX package's
on the CPU: AdamW (with and without master weights) and Adafactor, one
and three steps on the same params and the same gradients, through the
optimizer-state bridge; and the properties ``tests/test_train.py::
TestOptimizers`` asserts of the reference's.

The params are reduced starcoder2-3b's (the reference's stacked tree,
split into the port's layer list by ``models/bridge.py``); the gradients
are numpy draws from a seed, one set a step, given to both packages.
The reference's updates run under ``jax.jit``, as its train step runs
them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro_torch import optim as O
from repro_torch.configs import get_config
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.optim.optimizers import tree_leaves

# Same params, same gradients, the same f32 arithmetic in the same order:
# the two packages differ only where XLA and PyTorch round the same
# expression differently (a fused multiply-add, pow's last bit), which
# moves a moment or a param by an f32 ulp or two a step, of the leaf's
# own scale (a param near 0 after an update keeps the rounding of its
# terms).  1e-6 (8 f32 ulps), relative to each value and to the leaf's
# largest magnitude, bounds three steps; a wrong beta, bias correction,
# decay or factored axis moves them by far more than 1e-3.
F32_RTOL = 1e-6
# bf16 params under AdamW's master weights: each is its f32 master
# rounded to bf16, so an f32 ulp of the master may cross a bf16 rounding
# boundary: one bf16 ulp (2^-8 relative).
BF16_RTOL = 2.0 ** -8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(n_layers=None, dtype=jnp.float32):
    """Reduced starcoder2-3b's params (``n_layers`` deep) as the reference
    lays them out (the layers stacked on a leading axis) and the port's
    copy of them (``bridge.params_from_numpy``): the port's ``init`` from
    a seed, its layers stacked with numpy."""
    cfg = get_config("starcoder2-3b").reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    init = R.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    host = O.optimizers.tree_map(lambda t: t.numpy(), init)
    host["layers"] = jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                            *host["layers"])
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), host)
    # numpy has no bf16 the bridge could take: carry f32, cast after
    tp = bridge.params_from_numpy(
        _numpy(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jp)),
        device="cpu")
    tp = O.optimizers.tree_map(lambda t: t.to(_torch_dtype(dtype)), tp)
    return jp, tp


def _torch_dtype(dtype):
    return torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32


def _grads(jp, step):
    """Gradient draws for step ``step``: N(0, 1) x 10^U(-3, 0) a leaf, so
    the leaves' scales differ as a model's do."""
    rng = np.random.RandomState(100 + step)
    leaves, tdef = jax.tree_util.tree_flatten(jp)
    out = [(rng.standard_normal(x.shape) * 10.0 ** rng.uniform(-3, 0))
           .astype(np.float32) for x in leaves]
    return jax.tree_util.tree_unflatten(tdef, out)


def _close(got, want, rtol=F32_RTOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    atol = rtol * float(np.abs(want).max(initial=0.0)) + 1e-30
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# name -> (reference init, reference update, port init, port update,
#          param dtype, layers)
LR = JO.cosine_schedule(1e-2, 2, 10)
TLR = O.cosine_schedule(1e-2, 2, 10)
OPTIMIZERS = {
    "adamw": (lambda p: JO.adamw_init(p, keep_master=False),
              lambda p, g, s: JO.adamw_update(p, g, s, lr=LR),
              lambda p: O.adamw_init(p, keep_master=False),
              lambda p, g, s: O.adamw_update(p, g, s, lr=TLR),
              jnp.float32, None),
    "adamw_master_bf16": (
        lambda p: JO.adamw_init(p, keep_master=True),
        lambda p, g, s: JO.adamw_update(p, g, s, lr=LR),
        lambda p: O.adamw_init(p, keep_master=True),
        lambda p, g, s: O.adamw_update(p, g, s, lr=TLR),
        jnp.bfloat16, None),
    "adafactor": (JO.adafactor_init,
                  lambda p, g, s: JO.adafactor_update(p, g, s, lr=LR,
                                                      weight_decay=0.1),
                  O.adafactor_init,
                  lambda p, g, s: O.adafactor_update(p, g, s, lr=TLR,
                                                     weight_decay=0.1),
                  jnp.float32, None),
    # 8 layers: the reference's stacked (8, d) biases and norms are
    # factored, their column moment shared by the layers
    "adafactor_8_layers": (JO.adafactor_init,
                           lambda p, g, s: JO.adafactor_update(
                               p, g, s, lr=LR),
                           O.adafactor_init,
                           lambda p, g, s: O.adafactor_update(
                               p, g, s, lr=TLR),
                           jnp.float32, 8),
}


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_steps_match_reference(name, n_steps):
    """``n_steps`` updates on the same params and gradients: the port's
    params and state (through ``bridge.opt_state_from_numpy``) within
    F32_RTOL of the reference's functional update (bf16 params within a
    bf16 ulp)."""
    jinit, jupd, tinit, tupd, dtype, layers = OPTIMIZERS[name]
    jupd = jax.jit(jupd)
    jp, tp = _params(layers, dtype)
    js = jinit(jp)
    ts = tinit(tp)
    # the bridged initial state is the port's own
    bridged = bridge.opt_state_from_numpy(_numpy(js), device="cpu")
    for a, b in zip(tree_leaves(bridged), tree_leaves(ts)):
        assert a.shape == b.shape and torch.equal(a.float(), b.float())
    for step in range(n_steps):
        g = _grads(jp, step)
        jp, js = jupd(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts = tupd(tp, bridge.params_from_numpy(g, device="cpu"), ts)
    want_p = bridge.params_from_numpy(_numpy(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), jp)), device="cpu")
    rtol = BF16_RTOL if dtype == jnp.bfloat16 else F32_RTOL
    for got, want in zip(tree_leaves(tp), tree_leaves(want_p)):
        assert got.dtype == _torch_dtype(dtype)
        _close(got, want.numpy(), rtol=rtol)
    want_s = bridge.opt_state_from_numpy(_numpy(js), device="cpu")
    assert type(want_s) is type(ts)
    assert int(ts.step) == n_steps == int(want_s.step)
    got_leaves, want_leaves = tree_leaves(ts[1:]), tree_leaves(want_s[1:])
    assert len(got_leaves) == len(want_leaves) > 0
    for got, want in zip(got_leaves, want_leaves):
        assert got.shape == want.shape
        _close(got, want.numpy())


def test_update_is_in_place():
    """AdamW and Adafactor write the params and the state in place (the
    reference's donated buffers): the returned tensors are the given
    ones."""
    for name in ("adamw", "adafactor"):
        _, _, tinit, tupd, _, _ = OPTIMIZERS[name]
        _, tp = _params()
        ts = tinit(tp)
        before = [t.data_ptr() for t in tree_leaves((tp, ts))]
        g = O.optimizers.tree_map(torch.ones_like, tp)
        tp2, ts2 = tupd(tp, g, ts)
        assert tp2 is tp and ts2 is ts
        assert [t.data_ptr() for t in tree_leaves((tp2, ts2))] == before


def _quadratic(opt_name):
    """Both optimizers must drive a quadratic toward its minimum."""
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros((16, 3), requires_grad=True)}
    opt = O.make_optimizer(opt_name, lr=0.05, weight_decay=0.0)
    state = opt.init(params)

    def loss_fn(p):
        return torch.mean((p["w"] - target[None]) ** 2)
    for _ in range(200):
        g = torch.autograd.grad(loss_fn(params), [params["w"]])[0]
        params, state = opt.update(params, {"w": g}, state)
    return float(loss_fn(params).detach())


def _adafactor_memory_factored():
    p = {"w": torch.zeros((64, 32)), "b": torch.zeros((32,))}
    st = O.adafactor_init(p)
    assert st.vr["w"].shape == (64,)     # row moments
    assert st.vc["w"].shape == (32,)     # col moments
    assert st.vr["b"].shape == (32,)     # small leaf: full
    assert st.vc["b"].shape == (1,)      # its placeholder


def _clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = O.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    total = torch.sqrt(torch.sum(clipped["a"] ** 2))
    assert float(total) == pytest.approx(1.0, rel=1e-5)


def _cosine_schedule():
    lr = O.cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) == 0.0
    assert float(lr(torch.tensor(10))) == pytest.approx(1e-3, rel=1e-3)
    assert float(lr(torch.tensor(100))) == pytest.approx(0.0, abs=1e-6)
    # the reference's schedule, step by step
    jlr = JO.cosine_schedule(1e-3, warmup=10, total=100)
    for step in range(0, 101, 7):
        # (near the end 1 + cos cancels: f32 cos's last bit, 1e-7 of
        # the base rate)
        assert float(lr(torch.tensor(step, dtype=torch.int32))) == \
            pytest.approx(float(jlr(jnp.array(step))), rel=1e-6, abs=1e-10)


def _adamw_master_weights():
    p = {"w": torch.ones((8, 8), dtype=torch.bfloat16)}
    st = O.adamw_init(p, keep_master=True)
    assert st.master["w"].dtype == torch.float32
    assert st.step.dtype == torch.int32 and st.step.shape == ()


PROPERTIES = {
    "adamw_converges": lambda: _quadratic("adamw") < 1e-2,
    "adafactor_converges": lambda: _quadratic("adafactor") < 1e-2,
    "adafactor_memory_factored": _adafactor_memory_factored,
    "clip_by_global_norm": _clip_by_global_norm,
    "cosine_schedule": _cosine_schedule,
    "adamw_master_weights": _adamw_master_weights,
}


@pytest.mark.parametrize("case", list(PROPERTIES))
def test_optimizer_properties(case):
    """The reference's TestOptimizers, on the port."""
    assert PROPERTIES[case]() in (None, True)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        O.make_optimizer("sgd", lr=1e-3)
