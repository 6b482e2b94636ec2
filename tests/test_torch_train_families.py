"""Training of the five non-dense families against the JAX package on the
CPU, at reduced size: mamba2-1.3b (ssm), qwen2-moe-a2.7b (moe),
recurrentgemma-9b (hybrid, 8 layers: two groups and two leftover
recurrent blocks), whisper-medium (encdec) and llama-3.2-vision-90b
(vlm, 5 layers: two groups and a leftover plain layer).  For each: the
loss and every gradient leaf of ``runtime/steps.py::make_loss_fn``, one
``make_train_step``, remat on and off; the train launcher on the
token-only ssm config, and its refusal of encdec and vlm; the MoE
family's ``aux_load_balance_loss``.

The same weights go into both packages (the reference's ``init``, copied
through numpy by ``models/bridge.py``).  The vlm's ``x_gate`` inits to
zero, which would zero every gradient of a cross layer's attention, so
each group's gate is set nonzero (``GATES``) in the reference's tree
before it is copied.  Batches come from the data stream (tokens, labels)
and from numpy with a seed (encdec's frames, vlm's patches, bf16).  The
reference's attention on the CPU is its dense oracle, differentiated by
``jax.grad``; the port's is the kernel's plain version, differentiated
by the autograd Function (``kernels/ops.py::flash_attention``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as JM
from repro.models import registry as JR
from repro.optim import clip_by_global_norm as jclip_by_global_norm
from repro.optim import cosine_schedule as jcosine_schedule
from repro.optim import make_optimizer as jmake_optimizer
from repro.runtime import steps as JST
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train as TR
from repro_torch.models import bridge
from repro_torch.models import moe as M
from repro_torch.models import registry as R
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.optim import optimizers as O
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.runtime import steps as ST

from test_torch_optim import F32_RTOL, _close
from test_torch_train import _names, _numpy

# arch -> layers (None: reduced()'s own)
ARCHS = {"mamba2-1.3b": None, "qwen2-moe-a2.7b": None,
         "recurrentgemma-9b": 8, "whisper-medium": None,
         "llama-3.2-vision-90b": 5}
# each vlm group's tanh gate, set in place of the reference's zero init
# (eight: the Adafactor case at 16 layers has 8 groups)
GATES = (0.5, -0.75, 0.25, -0.5, 0.75, -0.25, 0.6, -0.6)
SEQ, BATCH = 32, 4
# The loss against the reference's: the bf16 activations of the two
# forwards part by an ulp here and there (f32 sums in other orders, bf16
# elementwise chains that jitted XLA rounds once and the port at each
# op; the MoE experts' weights are also bf16-rounded here where the
# reference's CPU path keeps them f32), which moves the f32 loss (about
# 6.6-7.0) by 3.1e-4 to 1.4e-3 (measured: hybrid, encdec, vlm below
# 4.6e-4; ssm 1.16e-3, moe 1.40e-3).  2e-3 bounds that; a missing layer,
# a wrong gate or a dropped source moves it by 1e-2 or more.
LOSS_ATOL = 2e-3
# Every gradient leaf, as ||g_port - g_ref|| / ||g_ref||: the dense
# family's bound (tests/test_torch_train.py: bf16 operands and cotangents
# an ulp apart here and there); measured 1.2-2.5% at worst for ssm, moe,
# encdec and vlm.  A leaf that misses a path (the cross attention behind
# its gate, the scan's carried state, the router's weighting of the
# combine) is off by tens of percent or more.
GRAD_RTOL = 0.03
# The hybrid amplifies those ulps (the RG-LRU's sqrt(1 - a^2) steepens
# as a nears 1): the reference parts from itself by up to 4.1% (median
# 2.8%) between remat on and off, and the port from it by 1.8-4.4%.  6%
# bounds that with the same margin.
GRAD_RTOL_BY_FAMILY = {"hybrid": 0.06}
# A 0-d leaf (the vlm's x_gate) is one sum of B·S·d products that cancel
# to 1/36 and 1/300 of their absolute sum at this config's two gates, so
# the ulps above weigh 36-300x more in it: measured 2.5% against JAX.
# 10%; a gate whose gradient misses its path is off by 100%.
SCALAR_GRAD_RTOL = 0.1
# grad_norm in the train step's metrics: the norm over every leaf of
# gradients that part as above.
GNORM_RTOL = 2e-3
# the aux loss and its gradients, all f32 on both sides: the same sums
# in other orders
AUX_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, n_layers=None):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    n_layers = n_layers or ARCHS[arch]
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


def _setup(arch, n_layers=None):
    """(jcfg, cfg, JAX params, the port's bridged copy); the vlm's gates
    set from GATES first."""
    jcfg, cfg = _cfgs(arch, n_layers)
    jp = JR.init(jax.random.PRNGKey(0), jcfg)
    if cfg.family == "vlm":
        g = jp["groups"]["xattn"]["x_gate"].shape[0]
        jp["groups"]["xattn"]["x_gate"] = jnp.asarray(GATES[:g], jnp.float32)
    return jcfg, cfg, jp, bridge.params_from_numpy(_numpy(jp), device="cpu")


def _batch(cfg, step=0):
    """The data stream's tokens and labels, and the family's bf16 source
    (encdec's frames, vlm's patches) from numpy: (JAX batch, port batch)."""
    tokens, labels = SyntheticLMData(cfg.vocab, SEQ, BATCH,
                                     seed=0).batch_at(step)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    source = {"encdec": ("encoder_embeds", cfg.enc_seq),
              "vlm": ("vision_embeds", cfg.n_patches)}.get(cfg.family)
    if source:
        name, n = source
        x = jnp.asarray(np.random.default_rng(1).standard_normal(
            (BATCH, n, cfg.d_model)), jnp.bfloat16)
        jb[name] = x
        tb[name] = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return jb, tb


def _attention_layers(cfg):
    """Attention calls of one forward: encoder layers, and each decoder
    layer's self and cross; every vlm layer and its cross; one a hybrid
    group; none in the ssm."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    if cfg.family == "vlm":
        return cfg.n_layers + cfg.n_layers // cfg.xattn_every
    return {"ssm": 0, "moe": cfg.n_layers,
            "hybrid": cfg.n_layers // 3}[cfg.family]


def _grads(cfg, tp, tb, remat=True):
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = ST.make_loss_fn(cfg, remat=remat)(tp, tb)
    return loss, torch.autograd.grad(loss, leaves)


def _grad_close(got, want, name, family):
    rel = float((got - want).norm() / want.norm())
    tol = (SCALAR_GRAD_RTOL if got.ndim == 0
           else GRAD_RTOL_BY_FAMILY.get(family, GRAD_RTOL))
    assert rel <= tol, (name, rel)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_every_grad_match_reference(arch):
    """``make_loss_fn``'s loss and the gradient of every param leaf
    against ``jax.value_and_grad(make_loss_fn(cfg))`` jitted, on the same
    weights and batch; the vlm's cross layers with their gates set, so
    their attention's gradients are not zero."""
    jcfg, cfg, jp, tp = _setup(arch)
    jb, tb = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(JST.make_loss_fn(jcfg)))(
        jp, jb)
    loss, grads = _grads(cfg, tp, tb)
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_ATOL
    want = tree_leaves(bridge.params_from_numpy(_numpy(jgrads),
                                                device="cpu"))
    assert len(grads) == len(want)
    for name, g, w in zip(_names(tp), grads, want):
        assert g.shape == w.shape, name
        if name.endswith("wk.b"):
            # exactly 0 (softmax cancels a per-query constant): both
            # packages' values are rounding noise
            continue
        _grad_close(g, w, name, cfg.family)
    if cfg.family == "vlm":
        cross = [i for i, lp in enumerate(tp["layers"]) if "xattn" in lp]
        names = _names(tp)
        for i in cross:
            wq = names.index(f".layers.{i}.xattn.wq.w")
            assert float(grads[wq].abs().max()) > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_matches_jitted_reference(arch):
    """One AdamW ``make_train_step`` (clip 1.0, the launcher's schedule)
    against the reference's jitted one: loss and grad_norm within their
    tolerances, and every leaf's update within 2·lr of the reference's
    (AdamW's first step moves each element by at most lr·(1 + wd·|p|),
    so a sign flip of a gradient near zero is the most two updates
    can part by); the leaves whose gradients are clear of the packages'
    disagreement (above 5% of the leaf's largest) equal it to f32
    rounding."""
    jcfg, cfg, jp, tp = _setup(arch)
    jb, tb = _batch(cfg)
    jopt = jmake_optimizer("adamw", lr=jcosine_schedule(1e-3, 20, 30))
    opt = make_optimizer("adamw", lr=cosine_schedule(1e-3, 20, 30))
    jnew, _, jm = jax.jit(JST.make_train_step(jcfg, jopt))(
        jp, jopt.init(jp), jb, jax.random.PRNGKey(0))
    _, grads = _grads(cfg, tp, tb)
    before = [t.detach().clone() for t in tree_leaves(tp)]
    new, state, m = ST.make_train_step(cfg, opt)(tp, opt.init(tp), tb, None)
    assert new is tp and int(state.step) == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=GNORM_RTOL)
    lr1 = 1e-3 / 20
    want_leaves = tree_leaves(bridge.params_from_numpy(_numpy(jnew),
                                                       device="cpu"))
    for name, old, got, want, g in zip(_names(tp), before, tree_leaves(new),
                                       want_leaves, grads):
        if name.endswith("wk.b"):
            continue
        du, dw = got.detach() - old, want - old
        assert float((du - dw).abs().max()) <= 2 * lr1 * 1.001, name
        clear = g.abs() > 0.05 * g.abs().max()
        if clear.any():
            torch.testing.assert_close(
                du[clear], dw[clear], rtol=1e-4,
                atol=1e-6 * max(float(old.abs().max()), 1.0))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_on_and_off_are_bitwise_equal(arch):
    """``remat`` recomputes each layer or group in the backward pass (the
    plain attention runs twice a call, not once) and changes no bit of
    the loss or of any gradient."""
    _, cfg, _, tp = _setup(arch)
    _, tb = _batch(cfg)
    out = {}
    for remat in (False, True):
        calls = FA.flash_attention_ref.calls
        bwd = FA.flash_attention_bwd.calls
        loss, grads = _grads(cfg, tp, tb, remat=remat)
        out[remat] = (loss, grads, FA.flash_attention_ref.calls - calls,
                      FA.flash_attention_bwd.calls - bwd)
    n = _attention_layers(cfg)
    assert out[False][2:] == (n, n)
    assert out[True][2:] == (2 * n, n)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


def test_launcher_trains_mamba2_until_the_loss_falls():
    """The reference's test_loss_decreases[mamba2-1.3b] through the
    launcher: 30 AdamW steps at lr 3e-3 on (8, 32) batches of the
    synthetic stream; exit 0 and the last 5 losses' mean more than 0.1
    below the first 5's."""
    run = TR.train(["--arch", "mamba2-1.3b", "--reduced", "--steps", "30",
                    "--seq-len", "32", "--batch", "8", "--lr", "3e-3",
                    "--log-every", "50", "--device", "cpu"])
    assert run.rc == 0 and len(run.losses) == 30
    assert np.mean(run.losses[-5:]) < np.mean(run.losses[:5]) - 0.1, \
        run.losses


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-90b"])
def test_launcher_refuses_source_families(arch, monkeypatch):
    """The launcher's batch is tokens and labels only, as the
    reference's: an encdec or vlm config is refused, naming the source
    its forward would need, before any param is built."""
    built = []
    monkeypatch.setattr(TR.R, "init", lambda *a, **k: built.append(a))
    name = TR.SOURCE_FAMILIES[get_config(arch).family]
    with pytest.raises(ValueError, match=name):
        TR.main(["--arch", arch, "--reduced", "--steps", "2",
                 "--device", "cpu"])
    assert not built


def test_aux_load_balance_loss_matches_reference():
    """``moe.aux_load_balance_loss`` at qwen2-moe's reduced width with 16
    experts: the value, and its gradients with respect to the router's
    weight and to x, against the reference's function under
    ``jax.value_and_grad`` (f32 throughout)."""
    jcfg, cfg = _cfgs("qwen2-moe-a2.7b")
    jcfg = dataclasses.replace(jcfg, n_experts=16)
    cfg = dataclasses.replace(cfg, n_experts=16)
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((cfg.d_model, 16)) * cfg.d_model ** -0.5
         ).astype(np.float32)
    x = rng.standard_normal((3, 10, cfg.d_model)).astype(np.float32)

    def jaux(w_, x_):
        return JM.aux_load_balance_loss({"router": {"w": w_}}, x_, jcfg)
    jval, (jdw, jdx) = jax.jit(jax.value_and_grad(jaux, argnums=(0, 1)))(
        jnp.asarray(w), jnp.asarray(x))
    tw, tx = (torch.from_numpy(a).requires_grad_(True) for a in (w, x))
    val = M.aux_load_balance_loss({"router": {"w": tw}}, tx, cfg)
    dw, dx = torch.autograd.grad(val, (tw, tx))
    assert val.dtype == torch.float32 and val.shape == ()
    assert float(val.detach()) == pytest.approx(float(jval), rel=AUX_RTOL)
    for got, want in ((dw, jdw), (dx, jdx)):
        want = torch.from_numpy(np.asarray(want))
        assert float(want.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=AUX_RTOL,
                                   atol=AUX_RTOL * float(want.abs().max()))


def _jfactored(shape) -> bool:
    """The reference's factoring rule (``repro.optim``'s ``_factored``),
    read off the shape of its stacked leaf."""
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


# the reduced configs at their own depth (no layer stack reaches 8), and
# two past 8: the vlm at 16 layers (8 groups of a plain and a cross
# layer, so each cross layer's 1-D norms stack (8, d) and factor) and a
# uniform family at 8 layers (each 1-D leaf's (8, d) stack factors).
# Past 8 layers the bf16 ulps of the two forwards compound (measured at
# 16 vlm layers: gradients up to 3.5% apart, past GRAD_RTOL, where the
# reference parts from itself by 0.9% between remat on and off), so
# there the update is held on the reference's own gradients alone.
ADAFACTOR_CASES = ([(arch, None) for arch in ARCHS]
                   + [("llama-3.2-vision-90b", 16), ("mamba2-1.3b", 8)])


@pytest.mark.parametrize(
    "arch,n_layers", ADAFACTOR_CASES,
    ids=[a if n is None else f"{a}-{n}-layers" for a, n in ADAFACTOR_CASES])
def test_adafactor_step_matches_jitted_reference(arch, n_layers):
    """One Adafactor step against the reference's, the optimizer
    stacking each layer list as the reference's tree stacks it (the vlm's
    plain layers on (groups, per group), its cross layers on (groups,),
    its leftover apart).  On the reference's own clipped gradients, the
    port's update and moments equal the reference's to f32 rounding,
    leaf by leaf; this holds the factoring of every stacked leaf (a
    stack's last two sides both >= 8, which a stack of 1-D leaves reaches
    at 8 layers or groups).  At the reduced depth, ``make_train_step``
    against the reference's jitted one: the loss within LOSS_ATOL, and
    every leaf updated as the reference updates it.  A leaf the reference
    factors divides g by its rows' and columns' mean g², so its update
    parts from the reference's as its gradient does (its family's
    GRAD_RTOL, in norm); an unfactored one moves by lr·sign(g) on the
    first step, equal to f32 rounding wherever the gradient is clear of
    the packages' disagreement (above 5% of the leaf's largest)."""
    jcfg, cfg, jp, tp = _setup(arch, n_layers)
    jb, tb = _batch(cfg)
    jopt = jmake_optimizer("adafactor", lr=jcosine_schedule(1e-2, 20, 30))
    opt = make_optimizer("adafactor", lr=cosine_schedule(1e-2, 20, 30))

    # the optimizer alone, on the reference's clipped gradients
    jgrads = jax.jit(jax.grad(JST.make_loss_fn(jcfg)))(jp, jb)
    jgrads, _ = jclip_by_global_norm(jgrads, 1.0)
    jnew, jstate = jax.jit(jopt.update)(jp, jgrads, jopt.init(jp))
    tp_ref = bridge.params_from_numpy(_numpy(jp), device="cpu")
    got_p, got_s = opt.update(
        tp_ref, bridge.params_from_numpy(_numpy(jgrads), device="cpu"),
        opt.init(tp_ref))
    want_s = bridge.opt_state_from_numpy(_numpy(jstate), device="cpu")
    assert int(got_s.step) == int(want_s.step) == 1
    got_m, want_m = tree_leaves(got_s[1:]), tree_leaves(want_s[1:])
    assert [t.shape for t in got_m] == [t.shape for t in want_m]
    want_leaves = tree_leaves(bridge.params_from_numpy(_numpy(jnew),
                                                       device="cpu"))
    for got, want in zip(got_m + tree_leaves(got_p),
                         want_m + want_leaves):
        _close(got, want.numpy(), rtol=F32_RTOL)
    if n_layers is not None:
        return

    # the whole step, on each package's own gradients
    jnew, _, jm = jax.jit(JST.make_train_step(jcfg, jopt))(
        jp, jopt.init(jp), jb, jax.random.PRNGKey(0))
    _, grads = _grads(cfg, tp, tb)
    before = [t.detach().clone() for t in tree_leaves(tp)]
    new, _, m = ST.make_train_step(cfg, opt)(tp, opt.init(tp), tb, None)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    want_leaves = tree_leaves(bridge.params_from_numpy(_numpy(jnew),
                                                       device="cpu"))
    # each port leaf flagged by the reference's rule on its stacked leaf
    factored = tree_leaves(bridge.params_from_numpy(_numpy(
        jax.tree_util.tree_map(
            lambda x: np.full(x.shape, float(_jfactored(x.shape)),
                              np.float32), jp)), device="cpu"))
    rtol = GRAD_RTOL_BY_FAMILY.get(cfg.family, GRAD_RTOL)
    for name, old, got, want, g, f in zip(_names(tp), before,
                                          tree_leaves(new), want_leaves,
                                          grads, factored):
        if name.endswith("wk.b"):
            continue
        du, dw = got.detach() - old, want - old
        assert float(du.norm()) > 0, name
        if bool(f.flatten()[0]):
            rel = float((du - dw).norm() / dw.norm())
            assert rel <= rtol, (name, rel)
        else:
            clear = g.abs() > 0.05 * g.abs().max()
            torch.testing.assert_close(du[clear], dw[clear], rtol=1e-4,
                                       atol=0.0)


def test_adafactor_refuses_a_layer_list_it_cannot_group():
    """A mixed layer list is stacked as G groups closed by one layer
    each: the vlm's layout at 8 groups leads its cross layers with (8,)
    and its plain ones with (8, 2); a list whose other structure does
    not come in multiples of G raises at init, naming the counts."""
    t = torch.zeros(16)
    plain, cross = {"w": t}, {"x": t}
    stacks = O._layer_stacks(([plain] * 2 + [cross]) * 8 + [plain])
    assert [s["w" if i != 1 else "x"].lead for i, s in
            enumerate(stacks)] == [(8, 2), (8,), (1,)]
    with pytest.raises(ValueError, match="occurs 3 times"):
        O.adafactor_init({"layers": [plain, plain, cross, plain, cross]})
