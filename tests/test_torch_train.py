"""The port's training path against the JAX package on the CPU, at reduced
size: the attention's gradient (``kernels/ops.py::flash_attention``, an
autograd Function whose backward is ``flash_attention_bwd``), the loss
and every gradient leaf of ``runtime/steps.py::make_loss_fn``, one
``make_train_step`` update, remat on and off, the loss falling, and the
train launcher end to end with a kill and a resume.

The same weights go into both packages (the reference's ``init``, copied
through numpy by ``models/bridge.py``); batches come from the data
stream, bitwise the same in both.  The reference's attention on the CPU
is its dense oracle (``ref.flash_attention_ref``, under
``ops.flash_attention``), differentiated by ``jax.grad``; the port's CPU
path is the kernel's plain version, differentiated by the Function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.models import registry as JR
from repro.optim import cosine_schedule as jcosine_schedule
from repro.optim import make_optimizer as jmake_optimizer
from repro.runtime import steps as JST
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.launch import train as TR
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.runtime import steps as ST

# The attention's gradient in f32 against autograd of the plain version
# and jax.grad of the reference's oracle: the same sums in other orders,
# an f32 ulp or two of the largest gradient (1e-5 of it bounds them; a
# wrong mask, scale or D term moves it by O(1)).
ATTN_F32_TOL = 1e-5
# The loss against the reference's: the two forwards' bf16 activations
# part by an ulp here and there (f32 sums in other orders), which moves
# the f32 loss (about 6.7 at this size) by up to 3e-4 (measured).
LOSS_ATOL = 1e-3
# Every gradient leaf, as ||g_port - g_ref|| / ||g_ref||: the weight
# gradients are bf16-rounded in both packages (the matmuls' operands are
# bf16), and the bf16 cotangents of the residual stream part by an ulp
# (2^-8) here and there, so the leaves differ by 0.09-1.34% (measured
# over both configs).  3% bounds that; a gradient missing a path (no
# attention gradient to wq, wk, wv: 100%) or a wrong scale or mask
# (tens of %) does not pass.
GRAD_RTOL = 0.03
# grad_norm in the train step's metrics: the norm over all leaves of
# gradients that part as above; measured within 5e-4 relative.
GNORM_RTOL = 2e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the attention's gradient
# ---------------------------------------------------------------------------

# (BH, Sq, Skv, hd, causal, window, kv_len)
GRAD_CASES = {
    "causal": (4, 32, 32, 32, True, None, None),
    "window": (2, 48, 48, 64, True, 16, None),
    "kv_len": (2, 40, 64, 32, False, None, 50),
    "causal_kv_len": (3, 24, 40, 16, True, None, 30),
    # rows 24-39 see no key: past Skv = 16 and the 8-key window
    "all_masked_rows": (2, 40, 16, 32, True, 8, None),
    "no_valid_key": (1, 8, 8, 16, False, None, 0),
}


def _qkv(case, dtype=torch.float32):
    bh, sq, skv, hd = case[:4]
    rng = np.random.RandomState(sum(case[:4]))
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((bh, sq, hd), (bh, skv, hd), (bh, skv, hd),
                                 (bh, sq, hd)))
    return [torch.from_numpy(x).to(dtype) for x in (q, k, v, do)]


def _close(got, want, tol=ATTN_F32_TOL):
    got, want = got.float(), torch.as_tensor(np.array(want)).float()
    assert got.shape == want.shape
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= tol * scale, (
        float((got - want).abs().max()), scale)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_attention_gradient_matches_autograd_and_jax(name):
    """``flash_attention_bwd`` against autograd of ``flash_attention_ref``
    and ``jax.grad`` of the reference's oracle, f32, for a random output
    gradient; a query row with no valid key gets dq = 0."""
    bh, sq, skv, hd, causal, window, kv_len = GRAD_CASES[name]
    q, k, v, do = _qkv(GRAD_CASES[name])
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    calls = FA.flash_attention_ref.calls
    got = FA.flash_attention_bwd(q, k, v, do, **kw)
    assert FA.flash_attention_ref.calls == calls      # no plain forward

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FA.flash_attention_ref(*leaves, out_dtype=torch.float32, **kw)
    want = torch.autograd.grad(out, leaves, do)

    def jloss(q_, k_, v_):
        o = JREF.flash_attention_ref(q_, k_, v_, out_dtype=jnp.float32, **kw)
        return jnp.sum(o * jnp.asarray(do.numpy()))
    jwant = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for g, w, jw in zip(got, want, jwant):
        assert g.dtype == torch.float32
        _close(g, w)
        _close(g, jw)
    kpos = np.arange(skv)[None, :]
    qpos = np.arange(sq)[:, None]
    valid = np.broadcast_to(kpos < (skv if kv_len is None else kv_len),
                            (sq, skv))
    if causal:
        valid = valid & (kpos <= qpos)
    if window is not None:
        valid = valid & (kpos > qpos - window)
    dead = ~valid.any(1)
    if name in ("all_masked_rows", "no_valid_key"):
        assert dead.any()
    assert not got[0][:, dead].any()


@pytest.mark.parametrize("window", [None, 8])
def test_flash_entry_point_differentiates_like_jax(window):
    """``ops.flash_attention`` on (B, S, H, hd), through autograd: its
    gradients equal ``jax.grad`` of the reference's ``ops.flash_attention``
    (its CPU oracle) in f32, and one backward is one
    ``flash_attention_bwd`` call and no plain forward."""
    rng = np.random.RandomState(3)
    q, k, v, do = (rng.standard_normal((2, 24, 3, 32)).astype(np.float32)
                   for _ in range(4))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True, window=window)
    calls, bwd = FA.flash_attention_ref.calls, FA.flash_attention_bwd.calls
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert FA.flash_attention_ref.calls == calls
    assert FA.flash_attention_bwd.calls == bwd + 1

    def jloss(q_, k_, v_):
        o = JOPS.flash_attention(q_, k_, v_, causal=True, window=window)
        return jnp.sum(o * do)
    jwant = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    for g, jw in zip(got, jwant):
        _close(g, jw)


def test_bf16_gradient_matches_autograd_of_the_plain_version():
    """In bf16 (the training path's dtype) the Function's gradients are
    autograd's of the plain version within a bf16 ulp: both are f32
    inside and round once at the end."""
    q, k, v, do = _qkv(GRAD_CASES["causal"], torch.bfloat16)
    qs, ks, vs = (t.reshape(2, 2, 32, 32).transpose(1, 2)
                  .requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(qs, ks, vs, causal=True)
    assert out.dtype == torch.bfloat16
    dout = do.reshape(2, 2, 32, 32).transpose(1, 2)
    got = torch.autograd.grad(out, [qs, ks, vs], dout)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = FA.flash_attention_ref(*leaves, causal=True)
    want = torch.autograd.grad(ref, leaves, do)
    for g, w in zip(got, want):
        g = g.transpose(1, 2).reshape(4, 32, 32)
        assert g.dtype == w.dtype == torch.bfloat16
        assert ((g.float() - w.float()).abs()
                <= 2.0 ** -7 * w.float().abs() + 1e-6).all()


# ---------------------------------------------------------------------------
# the loss, the gradients and the train step against the reference
# ---------------------------------------------------------------------------

ARCHS = ["starcoder2-3b", "mistral-nemo-12b"]


def _setup(arch):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = JR.init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(_numpy(jp), device="cpu")
    return jcfg, cfg, jp, tp


def _batch(vocab, step=0, seq=32, batch=4):
    tokens, labels = SyntheticLMData(vocab, seq, batch, seed=0).batch_at(step)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)})


def _grad_close(got, want):
    rel = float((got - want).norm() / want.norm())
    assert rel <= GRAD_RTOL, rel


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_match_reference(arch):
    """``make_loss_fn``'s loss and the gradient of every param leaf
    against ``jax.value_and_grad(make_loss_fn(cfg))`` jitted, on the same
    weights and batch: starcoder2-3b (LayerNorm, GELU, biases, tied head)
    and mistral-nemo-12b (RMSNorm, gated SiLU, untied head)."""
    jcfg, cfg, jp, tp = _setup(arch)
    jb, tb = _batch(jcfg.vocab)
    jloss, jgrads = jax.jit(jax.value_and_grad(JST.make_loss_fn(jcfg)))(
        jp, jb)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = ST.make_loss_fn(cfg)(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_ATOL
    want = tree_leaves(bridge.params_from_numpy(_numpy(jgrads),
                                                device="cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        _grad_close(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jitted_reference(arch):
    """One AdamW ``make_train_step`` (clip 1.0, the launcher's schedule)
    against the reference's jitted one: loss and grad_norm within their
    tolerances; each leaf's update -lr·(m̂/(√v̂+ε) + wd·p) equals the
    reference's to f32 rounding (of the update and of the params it is
    the difference of) wherever the gradient is clear of the packages'
    disagreement (|g| above 5% of the leaf's largest, by the port's
    gradient, itself within GRAD_RTOL of the reference's), and
    nowhere moves by more than the two updates' largest difference, a
    sign: 2·lr.  The key bias is left out: its exact gradient is 0 (a
    per-query constant that softmax cancels), so both packages' values
    are rounding noise."""
    jcfg, cfg, jp, tp = _setup(arch)
    jb, tb = _batch(jcfg.vocab)
    jopt = jmake_optimizer("adamw", lr=jcosine_schedule(1e-3, 20, 30))
    opt = make_optimizer("adamw", lr=cosine_schedule(1e-3, 20, 30))
    jnew, _, jm = jax.jit(JST.make_train_step(jcfg, jopt))(
        jp, jopt.init(jp), jb, jax.random.PRNGKey(0))
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    grads = torch.autograd.grad(ST.make_loss_fn(cfg)(tp, tb), leaves)
    before = [t.detach().clone() for t in leaves]
    step = ST.make_train_step(cfg, opt)
    new, state, m = step(tp, opt.init(tp), tb, None)
    assert new is tp and int(state.step) == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=GNORM_RTOL)
    lr1 = 1e-3 / 20
    names = _names(tp)
    for name, old, got, want, g in zip(
            names, before, tree_leaves(new),
            tree_leaves(bridge.params_from_numpy(_numpy(jnew),
                                                 device="cpu")), grads):
        if name.endswith("wk.b"):
            continue
        du, dw = got.detach() - old, want - old
        assert float((du - dw).abs().max()) <= 2 * lr1 * 1.001, name
        clear = g.abs() > 0.05 * g.abs().max()
        assert clear.any(), name
        # the updates are differences of params: f32 ulps of the params
        torch.testing.assert_close(du[clear], dw[clear], rtol=1e-4,
                                   atol=1e-6 * float(old.abs().max()))


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _names(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, list):
        return [n for i, x in enumerate(tree)
                for n in _names(x, f"{prefix}.{i}")]
    return [prefix]


def test_remat_on_and_off_are_bitwise_equal():
    """``remat`` recomputes each layer in the backward pass (the plain
    attention runs twice a layer, not once) and changes no bit of the
    loss or of any gradient."""
    _, cfg, _, tp = _setup("starcoder2-3b")
    _, tb = _batch(cfg.vocab)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for remat in (False, True):
        calls = FA.flash_attention_ref.calls
        loss = ST.make_loss_fn(cfg, remat=remat)(tp, tb)
        grads = torch.autograd.grad(loss, leaves)
        runs = FA.flash_attention_ref.calls - calls
        out[remat] = (loss, grads, runs)
    assert out[False][2] == cfg.n_layers
    assert out[True][2] == 2 * cfg.n_layers
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


def test_loss_decreases():
    """30 AdamW steps on the synthetic stream (the reference's
    test_loss_decreases, on the port): the last 5 losses' mean is more
    than 0.1 below the first 5's."""
    cfg = get_config("starcoder2-3b").reduced()
    params = R.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = make_optimizer("adamw", lr=3e-3)
    state = opt.init(params)
    step = ST.make_train_step(cfg, opt)
    data = SyntheticLMData(cfg.vocab, 32, 8, seed=0)
    losses = []
    for t in range(30):
        tokens, labels = data.batch_at(t)
        batch = {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(labels)}
        params, state, m = step(params, state, batch, None)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_cross_entropy_values():
    logits = torch.log(torch.tensor([[[0.7, 0.2, 0.1]]]))
    labels = torch.tensor([[0]])
    ce = ST.cross_entropy(logits, labels, z_loss=0.0)
    assert float(ce) == pytest.approx(-np.log(0.7), rel=1e-5)
    # with the z-loss, as the reference computes it
    x = np.random.RandomState(0).standard_normal((2, 3, 11)).astype(
        np.float32)
    y = np.random.RandomState(1).randint(0, 11, (2, 3))
    got = ST.cross_entropy(torch.from_numpy(x), torch.from_numpy(y))
    want = JST.cross_entropy(jnp.asarray(x), jnp.asarray(y))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "starcoder2-3b", "--reduced", "--steps", "12",
          "--seq-len", "32", "--batch", "4", "--log-every", "50",
          "--device", "cpu"]


class _Killed(Exception):
    pass


def test_train_launcher_kill_and_resume(tmp_path, monkeypatch):
    """run, kill, resume: a run killed at step 11 (its step-10 checkpoint
    committed) resumes from step 10 at data step 10, exits 0, and its
    steps' losses are bitwise the uninterrupted run's."""
    whole = TR.train(LAUNCH)
    assert whole.rc == 0 and whole.start_step == 0
    assert len(whole.losses) == 12 and np.all(np.isfinite(whole.losses))

    class Dying(SyntheticLMData):
        def batch_at(self, step, **kw):
            if step == 11:
                raise _Killed
            return super().batch_at(step, **kw)

    args = LAUNCH + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "5"]
    monkeypatch.setattr(TR, "SyntheticLMData", Dying)
    with pytest.raises(_Killed):
        TR.train(args)
    monkeypatch.undo()
    assert latest_step(str(tmp_path)) == 10
    resumed = TR.train(args + ["--resume", "auto"])
    assert resumed.rc == 0 and resumed.start_step == 10
    assert resumed.losses == whole.losses[10:]
    assert TR.main(args + ["--resume", "auto"]) == 0


def test_train_launcher_adafactor():
    """--optimizer adafactor trains through the launcher."""
    run = TR.train(LAUNCH + ["--optimizer", "adafactor", "--lr", "1e-2"])
    assert run.rc == 0 and np.all(np.isfinite(run.losses))


def test_refusals_name_their_roadmap_item():
    """The int8 gradient exchange is refused, naming ROADMAP queue 1,
    item 15; without --device the launcher needs the card.  (Every
    family trains: tests/test_torch_train_families.py.)"""
    with pytest.raises(NotImplementedError, match="item 15"):
        TR.main(LAUNCH + ["--grad-compression", "int8"])
    opt = make_optimizer("adamw", lr=1e-3)
    with pytest.raises(NotImplementedError, match="item 15"):
        ST.make_train_step(get_config("starcoder2-3b").reduced(), opt,
                           grad_compression="int8")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TR.main(LAUNCH[:-2])
