"""The port on the card: each CUDA kernel against its plain version (both
of qmatmul_w8a16's paths and both of qmatmul_w8a8's; the decode attention
kernels at G = 1, 4, 6 and 12, the silu drain at the dense configs' MLP
shapes), the engine, contiguous and paged, int8 and bf16 cache (the
other dense configs too), bit-for-bit against its
sequential reference, the serve launcher's forward through its kernels,
which path each caller takes, rmsnorm's row invariance, and the slot
tick, the decode loop and the chunk step captured as CUDA graphs
(bitwise the eager steps, the one-pass chunk bitwise the per-token one,
recaptured on other tensors, holding their workspace, engines taking
turns capturing once each, a failed capture raising), a paged serve
through preemption and injected faults equal to its control serve, the
threefry PRNG and the sampler on the card (bitwise the CPU's, rows
bitwise alone and in a batch), the captured sampled tick and a sampled
engine, the service curve's forward captured (bitwise the eager
one), the MoE family (the experts' stacked GEMV and tensor-core kernel
against their plain version and the 2-D launches, the live mask, the
router's rows, the forward's path, the engine greedy and sampled on
reduced qwen2-moe-a2.7b), speculative decoding (the captured verify and
propose steps bitwise their eager forms, the verify step bitwise k + 1
captured ticks, a speculating engine equal to its control), and the
encdec family (the captured prime bitwise the eager one, the plain
cross-attention's rows batch-invariant, the LM head padded to a multiple
of 4 columns, the engine on reduced whisper-medium equal to its
reference), the ssm family (the engine on reduced mamba2-1.3b equal
to its reference, the captured tick's freeze and scrub), and the hybrid
family (flash attention at head_dim 256; the engine on reduced
recurrentgemma-9b, its ring wrapped, equal to its reference), and
mixtral's int8 ring (the captured tick across the end of a 4,096-slot
ring at G = 6, each row bitwise its batch-1 step; the chunk across it
bitwise the per-token steps), at small shapes.

Every test here is marked ``gpu`` and skips without a CUDA device; the
module imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

``chip_smoke.py`` does the same checks at full starcoder2-3b width.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core.qlinear import W8A8, W8A16
from repro_torch.core.quant import QTensor, quantize_tree, quantize_weight
from repro_torch.kernels import decode_attention as A
from repro_torch.kernels import counts
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import qmatmul as K
from repro_torch.kernels import scratch
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.runtime import steps as ST

pytestmark = pytest.mark.gpu

ACTS = ("none", "relu", "gelu", "silu", "tanh", "sigmoid")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_qmatmul_kernel_matches_plain(cuda, x_dtype, out_dtype):
    """Every activation, with bias, M from 1 to 11 (two row slabs).  The
    kernel and the plain version add the same f32 products in other
    orders: f32 outputs agree to 1e-5 relative, bf16 ones to one ulp."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = quantize_weight(torch.randn((264, 96), generator=g, device=cuda))
    w, s = q.values, q.scale.reshape(-1).contiguous()
    b = torch.randn(96, generator=g, device=cuda)
    for m in (1, 3, 8, 11):
        x = torch.randn((m, 264), generator=g, device=cuda).to(x_dtype)
        for act in ACTS:
            got = K.qmatmul_w8a16(x, w, s, b, activation=act,
                                  out_dtype=out_dtype).float()
            want = K.qmatmul_w8a16_ref(x, w, s, b, activation=act,
                                       out_dtype=out_dtype).float()
            rel = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
            assert ((got - want).abs()
                    <= rel * want.abs() + 1e-5).all(), (m, act)


def test_qmatmul_kernel_rows_are_batch_invariant(cuda):
    """The GEMV's rows do not depend on M: the rows of an M = 11 launch
    and of an M = 16 launch (two row slabs) equal the same rows launched
    alone, on a narrow weight (one strip, K split in eight), wk|wv's
    N = 256 and w_down's K = 12288 (K split across blocks and combined
    in the last block to arrive)."""
    for m, k, n in ((11, 512, 64), (16, 3072, 256), (16, 12288, 256)):
        assert K.gemv_split_plan(k, n).splits > 1
        g = torch.Generator(device=cuda).manual_seed(1 + k)
        q = quantize_weight(torch.randn((k, n), generator=g, device=cuda))
        w, s = q.values, q.scale.reshape(-1).contiguous()
        x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
        full = K.qmatmul_w8a16(x, w, s, activation="gelu")
        for i in range(m):
            one = K.qmatmul_w8a16(x[i:i + 1].contiguous(), w, s,
                                  activation="gelu")
            assert torch.equal(one[0], full[i]), (m, k, n, i)
        assert torch.equal(K.qmatmul_w8a16(x[:8].contiguous(), w, s,
                                           activation="gelu"), full[:8])


# the mma path's edges: M one past 16-, 32- and 128-row tiles, K % 64 ==
# 16 (a ragged last stage), N % 16 == 4 (4-byte weight copies, a ragged
# 128-column strip) and a full-width projection
MMA_ROWS = (1, 17, 32, 33, 128, 512, 513)
MMA_KN = ((272, 100), (272, 260), (3088, 260), (3088, 3072))


def _close(got, want, out_dtype):
    """chip_smoke.bf16_close's tolerance: the kernel and the plain version
    add the same f32 products in other orders (the kernel scales each
    column's sum once, the plain version each weight), so they differ by
    f32 rounding: one bf16 ulp (2^-7 relative) in bf16, 1e-5 relative in
    f32, plus 1e-5 of the output's rms for values near zero."""
    got, want = got.float(), want.float()
    rel = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
    rms = want.pow(2).mean().sqrt()
    return bool(((got - want).abs() <= rel * want.abs() + 1e-5 * rms).all())


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", MMA_KN)
def test_qmatmul_w8a16_mma_matches_plain(cuda, k, n, out_dtype):
    """The tensor-core path at every M of MMA_ROWS, every activation, with
    and without bias, against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(k + n)
    q = quantize_weight(torch.randn((k, n), generator=g, device=cuda)
                        * k ** -0.5)
    w, s = q.values, q.scale.reshape(-1).contiguous()
    b = torch.randn(n, generator=g, device=cuda) * 0.1
    for m in MMA_ROWS:
        x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
        for act in ACTS:
            for bias in (None, b):
                got = K.qmatmul_w8a16_on_path("mma", x, w, s, bias,
                                              activation=act,
                                              out_dtype=out_dtype)
                want = K.qmatmul_w8a16_ref(x, w, s, bias, activation=act,
                                           out_dtype=out_dtype)
                assert got.dtype == out_dtype and got.shape == (m, n)
                assert _close(got, want, out_dtype), (m, act, bias is None)


def test_qmatmul_w8a16_mma_rows_are_batch_invariant(cuda):
    """A row's bits through the tensor-core path do not depend on M: the
    rows of an M = 512 and an M = 513 launch equal the same rows launched
    alone and in slices of 17 through the same path."""
    for m, k, n in ((512, 3072, 3072), (513, 3088, 260)):
        g = torch.Generator(device=cuda).manual_seed(m + k)
        q = quantize_weight(torch.randn((k, n), generator=g, device=cuda))
        w, s = q.values, q.scale.reshape(-1).contiguous()
        b = torch.randn(n, generator=g, device=cuda)
        x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
        for out_dtype in (torch.bfloat16, torch.float32):
            kw = dict(activation="gelu", out_dtype=out_dtype)
            full = K.qmatmul_w8a16_on_path("mma", x, w, s, b, **kw)
            for i in (0, 1, 15, 16, 127, 128, 300, m - 1):
                one = K.qmatmul_w8a16_on_path("mma", x[i:i + 1].contiguous(),
                                              w, s, b, **kw)
                assert torch.equal(one[0], full[i]), (m, i)
            for i in range(0, m, 17):
                part = K.qmatmul_w8a16_on_path("mma", x[i:i + 17].contiguous(),
                                               w, s, b, **kw)
                assert torch.equal(part, full[i:i + 17]), (m, i)


# the other dense configs' gated MLP at full width: w_gate + silu of
# internlm2-20b, mistral-nemo-12b and qwen1.5-32b, and qwen1.5-32b's w_down
# (K = 27,392, split in four by the GEMV's plan)
DENSE_KN = ((6144, 16384, "silu"), (5120, 14336, "silu"),
            (5120, 27392, "silu"), (27392, 5120, "none"))


@pytest.mark.parametrize("k,n,act", DENSE_KN)
def test_qmatmul_w8a16_dense_mlp_shapes_match_plain(cuda, k, n, act):
    """Both paths at the dense configs' MLP shapes, M = 1 and 8 (a tick)
    and 32 (a forward), bf16 out, against the plain version; the GEMV's
    rows of an M = 8 launch equal the rows launched alone."""
    g = torch.Generator(device=cuda).manual_seed(k + n)
    q = quantize_weight(torch.randn((k, n), generator=g, device=cuda)
                        * k ** -0.5)
    w, s = q.values, q.scale.reshape(-1).contiguous()
    for m in (1, 8, 32):
        x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
        want = K.qmatmul_w8a16_ref(x, w, s, activation=act)
        for path in K.W8A16_PATHS:
            got = K.qmatmul_w8a16_on_path(path, x, w, s, activation=act)
            assert _close(got, want, torch.bfloat16), (m, path)
        if m == 8:
            full = K.qmatmul_w8a16(x, w, s, activation=act)
            for i in range(m):
                one = K.qmatmul_w8a16(x[i:i + 1].contiguous(), w, s,
                                      activation=act)
                assert torch.equal(one[0], full[i]), i


def test_qmatmul_w8a16_mma_refuses_f32_x(cuda):
    x = torch.zeros((4, 16), device=cuda)
    w = torch.zeros((16, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        K.qmatmul_w8a16_on_path("mma", x, w, torch.ones(8, device=cuda))


def test_forward_takes_the_w8a16_mma_path_and_the_engine_the_gemv(cuda):
    """On the card at reduced width: the W8A16 forward launches only the
    tensor-core path (every projection and the LM head), an engine run
    only the GEMV."""
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    gen = torch.Generator(device=cuda).manual_seed(2)
    params = quantize_tree(R.init(gen, cfg, device=cuda), min_size=2048)
    by_path = K.qmatmul_w8a16.launches_by_path
    before = dict(by_path)
    out = ST.make_prefill_step(cfg, mode=W8A16)(
        params, {"tokens": torch.ones((2, 16), dtype=torch.int32,
                                      device=cuda)})
    assert out.shape == (2, 16, cfg.vocab) and torch.isfinite(out).all()
    assert by_path["mma"] - before["mma"] == 6 * cfg.n_layers + 1
    assert by_path["gemv"] == before["gemv"]
    before = dict(by_path)
    reqs = E.synthetic_requests(6, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=5, max_new_tokens=4)
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=9,
                   prefill_chunk=4)
    eng.serve(reqs)
    assert by_path["gemv"] > before["gemv"]
    assert by_path["mma"] == before["mma"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_rows_are_batch_invariant_on_card(cuda, dtype):
    """At d = 3072, each row of B = 8 and B = 16 calls equals the same
    row normalised alone, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn((16, 3072), generator=g, device=cuda) * 3).to(dtype)
    p = {"scale": 1 + 0.1 * torch.randn(3072, generator=g, device=cuda)}
    full = L.rmsnorm(p, x)
    assert torch.equal(L.rmsnorm(p, x[:8]), full[:8])
    for i in range(16):
        assert torch.equal(L.rmsnorm(p, x[i:i + 1])[0], full[i])


@pytest.mark.parametrize("append", [False, True])
@pytest.mark.parametrize("g_heads", [1, 4, 6, 12])
def test_decode_attention_kernel_matches_plain(cuda, g_heads, append):
    """Ragged valid_len including 0 and a full row, more than one slot
    tile (S=300), with and without the append column."""
    g = torch.Generator(device=cuda).manual_seed(2)
    b, s, kvh, hd = 4, 300, 2, 128
    q = torch.randn((b, kvh, g_heads, hd), generator=g,
                    device=cuda).to(torch.bfloat16)
    k = torch.randint(-127, 128, (b, s, kvh, hd), generator=g, device=cuda,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (b, s, kvh, hd), generator=g, device=cuda,
                      dtype=torch.int8)
    ks = torch.rand((b, s, kvh, 1), generator=g, device=cuda) * 0.02 + 1e-3
    vs = torch.rand((b, s, kvh, 1), generator=g, device=cuda) * 0.02 + 1e-3
    vl = torch.tensor([0, 1, 130, 300], dtype=torch.int32, device=cuda)
    kn = vn = None
    if append:
        kn = torch.randn((b, kvh, hd), generator=g, device=cuda)
        vn = torch.randn((b, kvh, hd), generator=g, device=cuda)
    got = A.decode_attention_int8(q, k, v, ks, vs, vl, k_new=kn, v_new=vn)
    want = A.decode_attention_int8_ref(q, k, v, ks, vs, vl, k_new=kn,
                                       v_new=vn)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_engine_on_card_equals_reference(cuda):
    """Reduced starcoder2-3b on the card: 12 requests through 4 slots with
    chunked prefill, every token equal to the sequential reference, and
    only the kernels launched (no plain version)."""
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = quantize_tree(R.init(gen, cfg, device=cuda), min_size=2048)
    reqs = E.synthetic_requests(12, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=5, max_new_tokens=6)
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=11,
                   prefill_chunk=4)
    K.qmatmul_w8a16_ref.calls = A.decode_attention_int8_ref.calls = 0
    launches = K.qmatmul_w8a16.launches
    rep = eng.serve(reqs)
    assert K.qmatmul_w8a16.launches > launches
    assert K.qmatmul_w8a16_ref.calls == 0
    assert A.decode_attention_int8_ref.calls == 0
    assert rep.outputs() == E.reference_outputs(
        cfg, params, reqs, mode=W8A16, max_seq=eng.max_seq)


def _paged_case(cuda, g, seed, b=4, bs=16, mb=20, kvh=2, hd=128):
    """Physical blocks, shuffled non-contiguous tables with trash entries
    past each row's frontier, ragged valid_len including 0, one block and
    more than two 128-slot tiles."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    nb = b * mb + 1
    q = torch.randn((b, kvh, g, hd), generator=gen,
                    device=cuda).to(torch.bfloat16)
    k = torch.randint(-127, 128, (nb, bs, kvh, hd), generator=gen,
                      device=cuda, dtype=torch.int8)
    v = torch.randint(-127, 128, (nb, bs, kvh, hd), generator=gen,
                      device=cuda, dtype=torch.int8)
    ks = torch.rand((nb, bs, kvh, 1), generator=gen, device=cuda) * 0.02 \
        + 1e-3
    vs = torch.rand((nb, bs, kvh, 1), generator=gen, device=cuda) * 0.02 \
        + 1e-3
    vls = [0, 1, 130, mb * bs][:b]
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    tables = torch.zeros((b, mb), dtype=torch.int32)
    for r, n in enumerate(vls):
        used = -(-n // bs)
        tables[r, :used] = perm[r * mb:r * mb + used]
    vl = torch.tensor(vls, dtype=torch.int32, device=cuda)
    return q, k, v, ks, vs, vl, tables.to(cuda)


@pytest.mark.parametrize("append", [False, True])
@pytest.mark.parametrize("g_heads", [1, 4, 6, 12])
def test_paged_kernel_matches_plain(cuda, g_heads, append):
    """The paged kernel against its plain version: the same f32 online
    softmax against a dense one, as for the contiguous kernel (1e-4
    relative, 1e-5 absolute)."""
    q, k, v, ks, vs, vl, tables = _paged_case(cuda, g_heads, 3)
    kn = vn = None
    if append:
        g = torch.Generator(device=cuda).manual_seed(4)
        kn = torch.randn((q.shape[0], q.shape[1], q.shape[3]), generator=g,
                         device=cuda)
        vn = torch.randn(kn.shape, generator=g, device=cuda)
    got = A.decode_attention_int8_paged(q, k, v, ks, vs, vl, tables,
                                        k_new=kn, v_new=vn)
    want = A.decode_attention_int8_paged_ref(q, k, v, ks, vs, vl, tables,
                                             k_new=kn, v_new=vn)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bs", [8, 16, 256])
def test_paged_kernel_bitwise_equals_contiguous_kernel(cuda, bs):
    """Whatever the block size, the paged kernel computes a row's bits as
    the contiguous kernel does on the gathered view — the property the
    paged engine's parity with its contiguous reference needs."""
    q, k, v, ks, vs, vl, tables = _paged_case(cuda, 12, 5, bs=bs,
                                              mb=320 // bs)
    got = A.decode_attention_int8_paged(q, k, v, ks, vs, vl, tables)
    g = A.paged_gather
    want = A.decode_attention_int8(
        q, g(k, tables).contiguous(), g(v, tables).contiguous(),
        g(ks, tables).contiguous(), g(vs, tables).contiguous(), vl)
    assert torch.equal(got, want)


# valid_len just before, at and after the edges of the chunks and warp
# tiles that the kernels split a row's slots into
# (kernels/decode_attention.py::decode_chunk_bounds)
SPLIT_EDGES = [0, 1, 15, 16, 17, 63, 64, 65, 255, 256, 257, 1023, 1024, 1025]


def _split_case(cuda, seed, vls, cap, bs=16, kvh=2, g=12, hd=128):
    """Rows of valid_len ``vls`` in a contiguous cache of ``cap`` slots,
    and the same rows in a paged pool of blocks of ``bs`` (each row's
    blocks at shuffled physical blocks, trash block 0 unused)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    b, mb = len(vls), cap // bs
    q = torch.randn((b, kvh, g, hd), generator=gen,
                    device=cuda).to(torch.bfloat16)
    cont = [torch.randint(-127, 128, (b, cap, kvh, hd), generator=gen,
                          device=cuda, dtype=torch.int8) for _ in range(2)]
    cont += [torch.rand((b, cap, kvh, 1), generator=gen, device=cuda) * 0.02
             + 1e-3 for _ in range(2)]
    nb = b * mb + 1
    tables = (torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        seed)) + 1).reshape(b, mb).to(torch.int32).to(cuda)
    pool = []
    for c in cont:
        phys = torch.zeros((nb, bs) + c.shape[2:], dtype=c.dtype, device=cuda)
        phys[tables.long().reshape(-1)] = c.reshape((b * mb, bs)
                                                    + c.shape[2:])
        pool.append(phys)
    vl = torch.tensor(vls, dtype=torch.int32, device=cuda)
    return q, cont, pool, tables, vl


def _attend(paged, q, cont, pool, tables, vl, rows=slice(None), **kw):
    """The paged or the contiguous kernel on ``rows`` of a _split_case."""
    if paged:
        return A.decode_attention_int8_paged(q[rows], *pool, vl[rows],
                                             tables[rows], **kw)
    return A.decode_attention_int8(q[rows], *(c[rows] for c in cont),
                                   vl[rows], **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_attention_split_matches_plain_at_chunk_edges(cuda, paged):
    """Rows on either side of every chunk and tile edge below 1,040
    slots: within the plain version's tolerance, and the paged kernel
    bitwise equal to the contiguous one."""
    q, cont, pool, tables, vl = _split_case(cuda, 11, SPLIT_EDGES, 1040)
    got = _attend(paged, q, cont, pool, tables, vl)
    want = (A.decode_attention_int8_paged_ref(q, *pool, vl, tables) if paged
            else A.decode_attention_int8_ref(q, *cont, vl))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got, _attend(not paged, q, cont, pool, tables, vl))


@pytest.mark.parametrize("paged", [False, True])
def test_decode_attention_rows_are_batch_invariant(cuda, paged):
    """Each row of an 8-row launch bitwise equal to the row launched
    alone: the chunks depend on the row's valid_len only."""
    vls = [1025, 17, 0, 640, 64, 300, 1, 129]
    q, cont, pool, tables, vl = _split_case(cuda, 12, vls, 1040)
    full = _attend(paged, q, cont, pool, tables, vl)
    for r in range(len(vls)):
        one = _attend(paged, q, cont, pool, tables, vl, slice(r, r + 1))
        assert torch.equal(one, full[r:r + 1])


@pytest.mark.parametrize("paged", [False, True])
def test_decode_attention_rows_are_capacity_invariant(cuda, paged):
    """The same rows bitwise equal in a 48-slot and in a 4,096-slot cache
    (paged: through 3- and 256-entry tables)."""
    vls = [0, 1, 5, 17, 47, 48, 24, 12]
    q, cont, pool, tables, vl = _split_case(cuda, 13, vls, 48)
    small = _attend(paged, q, cont, pool, tables, vl)
    if paged:
        wide = torch.zeros((len(vls), 256), dtype=torch.int32, device=cuda)
        wide[:, :tables.shape[1]] = tables
        big = A.decode_attention_int8_paged(q, *pool, vl, wide)
    else:
        cap = [torch.zeros((len(vls), 4096) + c.shape[2:], dtype=c.dtype,
                           device=cuda) for c in cont]
        for dst, src in zip(cap, cont):
            dst[:, :48] = src
        big = A.decode_attention_int8(q, *cap, vl)
    assert torch.equal(small, big)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_attention_append_column_at_edges(cuda, paged):
    """The append column with an empty cache gives exactly v_new, with
    none the row is zeros, and at chunk edges it matches the plain
    version."""
    vls = [0, 0, 64, 65, 1024, 1025]
    q, cont, pool, tables, vl = _split_case(cuda, 14, vls, 1040)
    gen = torch.Generator(device=cuda).manual_seed(15)
    kn = torch.randn((len(vls), 2, 128), generator=gen, device=cuda)
    vn = torch.randn(kn.shape, generator=gen, device=cuda)
    got = _attend(paged, q, cont, pool, tables, vl, k_new=kn, v_new=vn)
    want = (A.decode_attention_int8_paged_ref(q, *pool, vl, tables,
                                              k_new=kn, v_new=vn) if paged
            else A.decode_attention_int8_ref(q, *cont, vl, k_new=kn,
                                             v_new=vn))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got[0], vn[0][:, None, :].expand(2, 12, 128))
    bare = _attend(paged, q, cont, pool, tables, vl)
    assert torch.equal(bare[0], torch.zeros((2, 12, 128), device=cuda))


@pytest.mark.parametrize("paged", [False, True])
def test_decode_attention_back_to_back_launches_agree(cuda, paged):
    """Two launches of multi-chunk rows give the same bits, and leave the
    shared arrival counters at 0: the last block of each row resets its
    counter."""
    q, cont, pool, tables, vl = _split_case(cuda, 16, [1025, 300, 64, 0],
                                            1040)
    first = _attend(paged, q, cont, pool, tables, vl)
    second = _attend(paged, q, cont, pool, tables, vl)
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    counters = scratch._SCRATCH[(q.device.index, stream)][1]
    assert not counters.any()


def test_paged_engine_on_card_equals_reference(cuda):
    """Reduced starcoder2-3b on the card, paged with shared prefix blocks:
    every token equal to the contiguous sequential reference, blocks
    shared and all returned, and only the kernels launched."""
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = quantize_tree(R.init(gen, cfg, device=cuda), min_size=2048)
    reqs = E.synthetic_requests(12, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=6, max_new_tokens=5,
                                shared_prefix_len=4)
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=16,
                   prefill_chunk=4, block_size=4)
    A.decode_attention_int8_paged_ref.calls = 0
    launches = A.decode_attention_int8_paged.launches
    rep = eng.serve(reqs)
    assert A.decode_attention_int8_paged.launches > launches
    assert A.decode_attention_int8_paged_ref.calls == 0
    assert rep.shared_block_hits > 0 and rep.leaked_blocks == 0
    assert rep.outputs() == E.reference_outputs(
        cfg, params, reqs, mode=W8A16, max_seq=eng.max_seq)


def _w8a8_case(cuda, seed, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    xs = torch.rand((), generator=g, device=cuda) * 0.05 + 1e-3
    ws = torch.rand((n,), generator=g, device=cuda) * 0.05 + 1e-3
    b = torch.randn((n,), generator=g, device=cuda)
    return x, w, xs, ws, b


# M on both sides of the GEMV's 8- and 16-row tiles, of the path threshold
# (64) and of the tensor-core kernel's 128-row tiles; K % 32 == 16 (a
# ragged last k step of either kernel); N % 8 == 4 (a ragged n8 tile and
# 64- and 128-column strip)
W8A8_ROWS = (1, 8, 9, 16, 17, 33, 64, 65, 128, 512, 513)
W8A8_KN = ((272, 100), (3088, 260))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_qmatmul_w8a8_kernel_matches_plain(cuda, out_dtype):
    """Every activation, with bias, at every M of W8A8_ROWS (so through
    both kernels) and both (K, N) of W8A8_KN.  Without an activation the
    drain is the plain version's, step for step: bitwise.  With one, the
    kernel's tanhf/expf and PyTorch's activation kernels differ by a few
    f32 ulps: 1e-5 relative (f32) or one bf16 ulp (2^-7 relative), plus
    1e-6 absolute for the activations' tails."""
    for k, n in W8A8_KN:
        for m in W8A8_ROWS:
            x, w, xs, ws, b = _w8a8_case(cuda, m + k, m, k, n)
            for act in ACTS:
                got = K.qmatmul_w8a8(x, w, xs, ws, b, activation=act,
                                     out_dtype=out_dtype).float()
                want = K.qmatmul_w8a8_ref(x, w, xs, ws, b, activation=act,
                                          out_dtype=out_dtype).float()
                if act in ("none", "relu"):
                    assert torch.equal(got, want), (m, k, n, act)
                rel = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
                assert ((got - want).abs()
                        <= rel * want.abs() + 1e-6).all(), (m, k, n, act)


def test_qmatmul_w8a8_int32_accumulate_bitwise(cuda):
    """Unit scales, no bias, no activation, f32 out: the integer sums
    themselves (each |sum| < 2^24, exact in f32), through each kernel at
    every M of W8A8_ROWS, and through the wrapper's own choice."""
    for k, n in W8A8_KN + ((3072, 256),):
        for m in W8A8_ROWS:
            x, w, _, _, _ = _w8a8_case(cuda, 5 + m, m, k, n)
            one = torch.ones((), device=cuda)
            ones = torch.ones(n, device=cuda)
            want = K.qmatmul_w8a8_ref(x, w, one, ones)
            assert float(want.abs().max()) < 2 ** 24
            assert torch.equal(K.qmatmul_w8a8(x, w, one, ones), want)
            for path in K.W8A8_PATHS:
                got = K.qmatmul_w8a8_on_path(path, x, w, one, ones)
                assert torch.equal(got, want), (path, m, k, n)


def test_qmatmul_w8a8_rows_are_batch_invariant(cuda):
    """A row's bits do not depend on M or on the kernel: the rows of an
    M = 512 and an M = 513 launch (the tensor-core kernel) equal the same
    rows launched one at a time (the GEMV), and in slices of
    W8A8_GEMV_MAX_ROWS and one row more (either side of the threshold)."""
    t = K.W8A8_GEMV_MAX_ROWS
    for m, k, n in ((11, 512, 64), (512, 3088, 260), (513, 272, 100)):
        x, w, xs, ws, b = _w8a8_case(cuda, 6 + m, m, k, n)
        kw = dict(activation="gelu", out_dtype=torch.bfloat16)
        full = K.qmatmul_w8a8(x, w, xs, ws, b, **kw)
        for i in range(m):
            one = K.qmatmul_w8a8(x[i:i + 1].contiguous(), w, xs, ws, b, **kw)
            assert torch.equal(one[0], full[i]), (m, i)
        for size in (t, t + 1):
            for i in range(0, m, size):
                part = K.qmatmul_w8a8(x[i:i + size].contiguous(), w, xs, ws,
                                      b, **kw)
                assert torch.equal(part, full[i:i + size]), (m, size, i)


# (K, N) of each W8A8 projection of full-width starcoder2-3b (wq and wo
# share one) and a ragged shape: 4-byte weight copies, a ragged strip and a
# ragged last split
W8A8_PROJECTIONS = {"wq|wo": (3072, 3072), "wk|wv": (3072, 256),
                    "w_up": (3072, 12288), "w_down": (12288, 3072),
                    "ragged": (3088, 260)}


def _counters_zero(t):
    """The arrival counters of ``t``'s device and current stream are all
    0."""
    stream = torch.cuda.current_stream(t.device).cuda_stream
    return not scratch._SCRATCH[(t.device.index, stream)][1].any()


@pytest.mark.parametrize("name", list(W8A8_PROJECTIONS))
def test_qmatmul_w8a8_gemv_at_tick_rows(cuda, name):
    """The GEMV at M = 1, 8 and 16 on each projection shape (K split
    across blocks by w8a8_split_plan): its int32 accumulate bitwise equal
    to the plain version's and to the tensor-core kernel's, every row of
    the 16-row launch bitwise equal launched alone (bf16 drain, gelu, bias),
    and the arrival counters back at 0."""
    k, n = W8A8_PROJECTIONS[name]
    assert K.w8a8_split_plan(k, n).splits > 1
    x, w, xs, ws, b = _w8a8_case(cuda, 7 + k + n, 16, k, n)
    one, ones = torch.ones((), device=cuda), torch.ones(n, device=cuda)
    for m in (1, 8, 16):
        xm = x[:m].contiguous()
        assert K.w8a8_path(m) == "gemv"
        got = K.qmatmul_w8a8(xm, w, one, ones)
        want = K.qmatmul_w8a8_ref(xm, w, one, ones)
        assert float(want.abs().max()) < 2 ** 24
        assert torch.equal(got, want), (name, m)
        assert torch.equal(K.qmatmul_w8a8_on_path("mma", xm, w, one, ones),
                           got), (name, m)
        assert _counters_zero(x)
    kw = dict(activation="gelu", out_dtype=torch.bfloat16)
    full = K.qmatmul_w8a8(x, w, xs, ws, b, **kw)
    for i in range(16):
        alone = K.qmatmul_w8a8(x[i:i + 1].contiguous(), w, xs, ws, b, **kw)
        assert torch.equal(alone[0], full[i]), (name, i)
    assert torch.equal(K.qmatmul_w8a8(x[:8].contiguous(), w, xs, ws, b,
                                      **kw), full[:8])
    assert _counters_zero(x)


def test_w8a8_tick_shares_the_scratch_with_the_other_split_kernels(cuda):
    """A W8A8 tick's launches, a W8A16 GEMV launch and a decode attention
    launch, each splitting its work across blocks through the one
    workspace and counter array of the stream, back to back and twice
    over: each output equals its plain version (the W8A8 sums bitwise, the
    others within the tolerances of their own tests) and is the same both
    times, and the counters end at 0."""
    cases = [_w8a8_case(cuda, 30 + i, 16, k, n)[:2]
             for i, (k, n) in enumerate(W8A8_PROJECTIONS.values())]
    one = torch.ones((), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(31)
    q16 = quantize_weight(torch.randn((12288, 256), generator=g, device=cuda))
    w16, s16 = q16.values, q16.scale.reshape(-1).contiguous()
    x16 = torch.randn((16, 12288), generator=g, device=cuda).to(torch.bfloat16)
    assert K.gemv_split_plan(12288, 256).splits > 1
    q, cont, pool, tables, vl = _split_case(cuda, 32, [1025, 300, 64, 0],
                                            1040)
    runs = []
    for _ in range(2):
        outs = [K.qmatmul_w8a8(x, w, one, torch.ones(w.shape[1], device=cuda))
                for x, w in cases]
        outs.append(K.qmatmul_w8a16(x16, w16, s16, out_dtype=torch.float32))
        outs.append(_attend(False, q, cont, pool, tables, vl))
        runs.append(outs)
    for (x, w), got in zip(cases, runs[0]):
        assert torch.equal(got, K.qmatmul_w8a8_ref(
            x, w, one, torch.ones(w.shape[1], device=cuda)))
    assert _close(runs[0][-2], K.qmatmul_w8a16_ref(
        x16, w16, s16, out_dtype=torch.float32), torch.float32)
    torch.testing.assert_close(runs[0][-1], A.decode_attention_int8_ref(
        q, *cont, vl), rtol=1e-4, atol=1e-5)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert _counters_zero(q)


FLASH_CASES = [
    (3, 64, 64, 32, True, None, None),
    (2, 48, 48, 64, True, 16, None),
    (2, 40, 64, 32, True, None, 50),
    (1, 37, 90, 128, False, None, 77),
    (2, 33, 33, 16, True, 5, 20),
    (24, 32, 32, 128, True, None, None),          # the service curve's
    (2, 200, 200, 128, True, None, None),         # several tiles each way
    (3, 45, 45, 24, True, None, None),            # hd not a multiple of 16
    (2, 50, 75, 64, False, 20, None),             # Skv not a multiple of 32
    (16, 32, 32, 256, True, 2048, None),          # recurrentgemma's curve
    (2, 200, 200, 256, True, 64, None),           # hd 256, the window bites
    (2, 45, 70, 136, False, None, 60),            # hd 136: the HD = 256
    (3, 40, 40, 200, True, None, None),           # instance, ragged columns
]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,skv,hd,causal,window,kv_len", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, bh, sq, skv, hd, causal, window,
                                    kv_len, out_dtype):
    """bf16 inputs.  The kernel's online softmax over 32-key tiles against
    the plain version's dense f32 softmax: the same terms in other orders,
    2e-5 relative and absolute in f32 (as the JAX package holds its kernel
    to its oracle), one bf16 ulp in bf16."""
    g = torch.Generator(device=cuda).manual_seed(bh + sq + skv)
    q, k, v = (torch.randn((bh, n, hd), generator=g, device=cuda)
               .to(torch.bfloat16) for n in (sq, skv, skv))
    kw = dict(causal=causal, window=window, kv_len=kv_len,
              out_dtype=out_dtype)
    got = FA.flash_attention_bhsd(q, k, v, **kw).float()
    want = FA.flash_attention_ref(q, k, v, **kw).float()
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert ((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-5).all()


def test_bf16_engine_on_card_equals_reference(cuda):
    """Reduced starcoder2-3b on the bf16 cache on the card: 12 requests
    through 4 slots with chunked prefill, every token equal to the
    sequential batch-1 reference (the bf16 attention's products are
    batched over the rows of the tick there and over one row here)."""
    cfg = get_config("starcoder2-3b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = quantize_tree(R.init(gen, cfg, device=cuda), min_size=2048)
    reqs = E.synthetic_requests(12, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=5, max_new_tokens=6)
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=11,
                   prefill_chunk=4)
    rep = eng.serve(reqs)
    assert rep.outputs() == E.reference_outputs(
        cfg, params, reqs, mode=W8A16, max_seq=eng.max_seq)


@pytest.mark.parametrize("kvh,g", [(40, 1), (8, 4), (8, 6), (2, 12)])
def test_bf16_cache_attention_rows_are_batch_invariant_on_card(cuda, kvh, g):
    """The bf16 cache's attention (plain PyTorch, summed by
    ``layers.tree_sum``) at the dense configs' head groupings: each row of
    an 8-row call equals the row computed alone, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(kvh + g)
    b, s, hd = 8, 48, 128
    q = torch.randn((b, kvh, g, hd), generator=gen, device=cuda)
    ck = torch.randn((b, s, kvh, hd), generator=gen,
                     device=cuda).to(torch.bfloat16)
    cv = torch.randn((b, s, kvh, hd), generator=gen,
                     device=cuda).to(torch.bfloat16)
    vl = torch.tensor([1, 5, 17, 48, 30, 2, 47, 16], dtype=torch.int32,
                      device=cuda)
    full = L.bf16_cache_attention(q, ck, cv, vl)
    for r in range(b):
        one = L.bf16_cache_attention(q[r:r + 1], ck[r:r + 1], cv[r:r + 1],
                                     vl[r:r + 1])
        assert torch.equal(one[0], full[r]), r


# the other dense configs at reduced size with their own head grouping
# (tests/test_torch_dense_family.py holds them against the JAX package)
DENSE_QUIRKS = {
    "internlm2-20b": dict(d_model=384, n_heads=12, n_kv_heads=2),
    "mistral-nemo-12b": dict(d_model=320, n_heads=8, n_kv_heads=2),
    "qwen1.5-32b": dict(d_model=512, n_heads=16, n_kv_heads=16),
}


@pytest.mark.parametrize("arch", ["starcoder2-3b"] + list(DENSE_QUIRKS))
def test_streamed_init_equals_quantize_tree_on_card(cuda, arch):
    """On the card too, ``registry.init_quantized`` gives the bits of
    ``quantize_tree(init(...), min_size=2048)`` from the same seed, its
    tables quantized a chunk of rows at a time."""
    cfg = get_config(arch).reduced()
    whole = quantize_tree(R.init(torch.Generator(device=cuda).manual_seed(5),
                                 cfg, device=cuda), min_size=2048)
    old = R.module_for(cfg).TABLE_ROW_CHUNK
    R.module_for(cfg).TABLE_ROW_CHUNK = 100
    try:
        streamed = R.init_quantized(
            torch.Generator(device=cuda).manual_seed(5), cfg, device=cuda)
    finally:
        R.module_for(cfg).TABLE_ROW_CHUNK = old
    flat = []

    def leaves(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                leaves(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                leaves(x, y)
        else:
            flat.append((a, b))

    leaves(whole, streamed)
    for a, b in flat:
        assert type(a) is type(b)
        pairs = ([(a.values, b.values), (a.scale, b.scale)]
                 if isinstance(a, QTensor) else [(a, b)])
        for x, y in pairs:
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("arch", list(DENSE_QUIRKS))
def test_dense_bf16_engines_on_card_equal_reference(cuda, arch):
    """A reduced dense config on the bf16 cache on the card, weights from
    the streamed init: 12 requests through 4 slots with chunked prefill,
    contiguous and paged (blocks of 4, a shared prefix block, a pool below
    the worst case), every token equal to the sequential batch-1
    reference, no block leaked."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              **DENSE_QUIRKS[arch])
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = R.init_quantized(gen, cfg, device=cuda)
    reqs = E.synthetic_requests(12, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=6, max_new_tokens=5,
                                shared_prefix_len=4)
    kw = dict(mode=W8A16, num_slots=4, max_seq=16, prefill_chunk=4)
    want = E.reference_outputs(cfg, params, reqs, mode=W8A16, max_seq=16)
    assert E.Engine(cfg, params, **kw).serve(reqs).outputs() == want
    rep = E.Engine(cfg, params, block_size=4, num_blocks=10,
                   **kw).serve(reqs)
    assert rep.outputs() == want
    assert rep.leaked_blocks == 0 and rep.shared_block_hits > 0


@pytest.mark.parametrize("batch", [1, 2])
def test_forward_on_card_runs_its_kernels(cuda, batch):
    """The prefill step at reduced width on the card, W8A8 (batch 1 too:
    there the head-major reshape is a strided view): the flash and
    the w8a8 kernels launch (and the w8a16 one for the LM head), no plain
    version is called, and the logits are close to the CPU forward's on
    the same weights (bf16 rounding of other f32 sums: within 0.2, as the
    CPU tests hold W8A8 logits to the JAX forward)."""
    cfg = get_config("starcoder2-3b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(1)
    params = quantize_tree(R.init(gen, cfg, device=cuda), min_size=2048)
    toks = torch.randint(1, cfg.vocab, (batch, 16), device=cuda,
                         dtype=torch.int32)
    FA.flash_attention_ref.calls = K.qmatmul_w8a8_ref.calls = 0
    launches = (FA.flash_attention_bhsd.launches, K.qmatmul_w8a8.launches)
    out = ST.make_prefill_step(cfg, mode=W8A8)(params, {"tokens": toks})
    assert FA.flash_attention_bhsd.launches - launches[0] == cfg.n_layers
    assert K.qmatmul_w8a8.launches - launches[1] == 6 * cfg.n_layers
    assert FA.flash_attention_ref.calls == K.qmatmul_w8a8_ref.calls == 0
    assert out.shape == (batch, 16, cfg.vocab) and torch.isfinite(out).all()

    def to_cpu(node):
        if isinstance(node, dict):
            return {k: to_cpu(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_cpu(v) for v in node]
        if isinstance(node, torch.Tensor):
            return node.cpu()
        return dataclasses.replace(node, values=node.values.cpu(),
                                   scale=node.scale.cpu())

    cpu = ST.make_prefill_step(cfg, mode=W8A8)(to_cpu(params),
                                               {"tokens": toks.cpu()})
    assert float((out.cpu() - cpu).abs().max()) <= 0.2


# ---------------------------------------------------------------------------
# the captured steps (runtime/graphs.py, runtime/steps.py jit_*)
# ---------------------------------------------------------------------------

GRAPH_BS = 4         # block size of the paged cases


def tick_schedule(slots, max_seq, ticks, vocab, seed, mb=0):
    """The inputs of ``ticks`` slot ticks over ``slots`` rows, as numpy:
    ``tokens`` (S, 1), ``index`` (S,), ``active`` (S,) and, with ``mb``
    blocks a row, ``tables`` (S, mb) into a pool of ``slots * mb + mb +
    1`` blocks (block 0 the trash block).  Rows start at spread positions
    (each below ``max_seq - ticks``) and advance while active; row 1
    retires at tick 2 (index 0, its table pointed at trash) and is
    admitted again at tick 3 at position 0 on spare blocks; the last row
    retires at tick 4.  Tokens are random, each tick's own."""
    rng = np.random.default_rng(seed)
    index = (np.arange(slots) * 7 % (max_seq - ticks)).astype(np.int32)
    active = np.ones(slots, bool)
    blocks = rng.permutation(np.arange(1, slots * mb + mb + 1))
    tables = blocks[:slots * mb].reshape(slots, mb).astype(np.int32) \
        if mb else None
    out = []
    for t in range(ticks):
        if t == 2:
            active[1], index[1] = False, 0
            if mb:
                tables[1] = 0
        if t == 3:
            active[1] = True
            if mb:
                tables[1] = blocks[slots * mb:]
        if t == 4:
            active[-1] = False
        out.append({"tokens": rng.integers(1, vocab, (slots, 1)).astype(
                        np.int32),
                    "index": index.copy(), "active": active.copy(),
                    "tables": None if tables is None else tables.copy()})
        index = index + active
    return out


def fill_history(cfg, params, mode, cache, upto, seed):
    """Write positions 0 .. upto-1 of every row (through a paged cache's
    tables) with the eager decode step on random tokens, so that the
    ticks attend to a history of real k/v."""
    decode = ST.make_decode_step(cfg, mode=mode)
    rows = (cache["block_tables"] if "block_tables" in cache
            else cache["k"][0]).shape[0]
    rng = np.random.default_rng(seed)
    with torch.inference_mode():
        for t in range(upto):
            toks = torch.from_numpy(rng.integers(1, cfg.vocab, (rows, 1))
                                    .astype(np.int32))
            decode(params, {"tokens": toks.to(cache["k"].device),
                            "cache_index": t}, cache, logits=False)


def tick_args(tick, device):
    return tuple(torch.from_numpy(tick[k]).to(device)
                 for k in ("tokens", "index", "active"))


# name -> (mode, paged, kv_quant)
GRAPH_KINDS = {"contiguous": (W8A16, False, True),
               "paged": (W8A16, True, True),
               "w8a8": (W8A8, False, True),
               "bf16": (W8A16, False, False)}


def _graph_case(cuda, kind, slots=4, max_seq=16, ticks=6, seed=0):
    """Reduced starcoder2-3b on the card, a cache with a history and a
    tick schedule."""
    mode, paged, kv_quant = GRAPH_KINDS[kind]
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=kv_quant)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    params = quantize_tree(R.init(gen, cfg, device=cuda), min_size=2048)
    mb = max_seq // GRAPH_BS if paged else 0
    sched = tick_schedule(slots, max_seq, ticks, cfg.vocab, seed, mb)
    if paged:
        cache = R.init_paged_cache(cfg, slots, max_seq, GRAPH_BS,
                                   slots * mb + mb + 1, device=cuda)
        cache["block_tables"].copy_(torch.from_numpy(sched[0]["tables"]))
    else:
        cache = R.init_cache(cfg, slots, max_seq, device=cuda)
    fill_history(cfg, params, mode, cache, max_seq - ticks, seed)
    return cfg, params, mode, cache, sched


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _counted_call(fn, *args):
    before = counts.snapshot()
    out = fn(*args)
    return out, counts.difference(counts.snapshot(), before)


@pytest.mark.parametrize("kind", list(GRAPH_KINDS))
def test_captured_tick_equals_eager(cuda, kind):
    """Six ticks, rows retiring and admitted between them (paged: a table
    row changed in place): the captured tick's next tokens, indices and
    every cache leaf bitwise equal to the eager tick's on a copy of the
    cache; one capture; the launch counts of a replay equal the eager
    tick's (the first call: twice, the warm-up's and the replay's)."""
    cfg, params, mode, cache, sched = _graph_case(cuda, kind)
    eager = ST.make_slot_decode_step(cfg, mode=mode)
    graphed = ST.jit_slot_decode_step(ST.make_slot_decode_step(cfg,
                                                               mode=mode))
    other = _clone(cache)
    with torch.inference_mode():
        for t, tick in enumerate(sched):
            if tick["tables"] is not None:
                for c in (cache, other):
                    c["block_tables"].copy_(torch.from_numpy(tick["tables"]))
            args = tick_args(tick, cuda)
            (n_e, _, i_e), per_eager = _counted_call(
                eager, params, args[0], cache, args[1], args[2])
            (n_g, _, i_g), per_graph = _counted_call(
                graphed, params, args[0], other, args[1], args[2])
            assert torch.equal(n_g, n_e) and torch.equal(i_g, i_e), t
            assert (i_e.cpu().numpy()
                    == tick["index"] + tick["active"]).all()
            for name in cache:
                assert torch.equal(other[name], cache[name]), (t, name)
            assert per_eager and per_graph == {
                k: n * (2 if t == 0 else 1) for k, n in per_eager.items()}
    assert graphed.captured.captures == 1
    assert graphed.binding(params, args[0], other, args[1],
                           args[2]).launches == per_eager


def test_captured_tick_recaptures_on_other_tensors(cuda):
    """A captured tick called on a second cache and with one param leaf
    replaced captures anew each time (never replaying against tensors it
    did not capture); back on the first cache it replays the graph it
    keeps for it; each result equals the eager tick's on the same
    cache."""
    cfg, params, mode, cache, sched = _graph_case(cuda, "contiguous")
    eager = ST.make_slot_decode_step(cfg, mode=mode)
    graphed = ST.jit_slot_decode_step(ST.make_slot_decode_step(cfg,
                                                               mode=mode))
    caches = {"a": _clone(cache), "b": _clone(cache)}
    mirrors = {"a": _clone(cache), "b": _clone(cache)}
    swapped = dict(params, ln_f={k: v.clone()
                                 for k, v in params["ln_f"].items()})
    with torch.inference_mode():
        for t, (name, p, want) in enumerate((
                ("a", params, 1), ("a", params, 1), ("b", params, 2),
                ("a", params, 2), ("a", swapped, 3), ("a", swapped, 3))):
            args = tick_args(sched[t], cuda)
            n_g, _, i_g = graphed(p, args[0], caches[name], *args[1:])
            n_e, _, i_e = eager(p, args[0], mirrors[name], *args[1:])
            assert graphed.captured.captures == want, t
            assert torch.equal(n_g, n_e) and torch.equal(i_g, i_e), t
            for c in caches:
                for leaf in caches[c]:
                    assert torch.equal(caches[c][leaf], mirrors[c][leaf])


def test_captured_steps_keep_their_workspace(cuda):
    """The 8-row tick captured first, then a 16-row W8A8 tick and a
    16-row decode loop, whose larger launches replace the capture
    stream's workspace: the 8-row tick holds on to the one it was
    captured with, replays equal to the eager tick, and every arrival
    counter ends at 0."""
    from repro_torch.runtime import graphs as G
    cfg, params, mode, cache, sched = _graph_case(cuda, "contiguous",
                                                  slots=8)
    eager8 = ST.make_slot_decode_step(cfg, mode=mode)
    tick8 = ST.jit_slot_decode_step(ST.make_slot_decode_step(cfg, mode=mode))
    mirror = _clone(cache)
    with torch.inference_mode():
        args = tick_args(sched[0], cuda)
        tick8(params, args[0], cache, *args[1:])
        eager8(params, args[0], mirror, *args[1:])
        held = tick8.binding(params, args[0], cache, *args[1:]).scratch
        assert held
        _, params16, _, cache16, sched16 = _graph_case(cuda, "w8a8",
                                                       slots=16, seed=1)
        tick16 = ST.jit_slot_decode_step(ST.make_slot_decode_step(
            cfg, mode=W8A8))
        args16 = tick_args(sched16[0], cuda)
        mirror16 = _clone(cache16)
        n16, _, _ = tick16(params16, args16[0], cache16, *args16[1:])
        e16 = ST.make_slot_decode_step(cfg, mode=W8A8)(
            params16, args16[0], mirror16, *args16[1:])[0]
        assert torch.equal(n16, e16)
        bcfg = dataclasses.replace(cfg, kv_quant=False)
        loop = ST.jit_decode_loop(ST.make_decode_loop(bcfg, mode=W8A16,
                                                      num_tokens=3))
        lcache = R.init_cache(bcfg, 16, 16, device=cuda)
        loop(params16, torch.ones((16, 1), dtype=torch.int32,
                                  device=cuda), lcache, 0)
        side = G.capture_stream(cuda).cuda_stream
        now = scratch.held(cache["k"].device, side)
        assert now[0].data_ptr() != held[0].data_ptr()     # it grew
        for tick in sched[1:3]:
            args = tick_args(tick, cuda)
            n_g, _, i_g = tick8(params, args[0], cache, *args[1:])
            n_e, _, i_e = eager8(params, args[0], mirror, *args[1:])
            assert torch.equal(n_g, n_e) and torch.equal(i_g, i_e)
            for name in cache:
                assert torch.equal(cache[name], mirror[name])
    torch.cuda.synchronize()
    assert tick8.captured.captures == 1
    for pair in [held, now] + [e for e in scratch._SCRATCH.values()]:
        assert not pair[1].any()


@pytest.mark.parametrize("mode", [W8A16, W8A8], ids=["w8a16", "w8a8"])
def test_captured_decode_loop_equals_eager(cuda, mode):
    """The serve CLI's loop form (bf16 cache), 5 tokens at starts 0 and
    3 on one graph: tokens and cache bitwise the eager loop's, which
    steps an int position where the captured loop steps a tensor."""
    cfg = get_config("starcoder2-3b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(2)
    params = quantize_tree(R.init(gen, cfg, device=cuda), min_size=2048)
    eager = ST.make_decode_loop(cfg, mode=mode, num_tokens=5)
    graphed = ST.jit_decode_loop(ST.make_decode_loop(cfg, mode=mode,
                                                     num_tokens=5))
    cache = R.init_cache(cfg, 4, 16, device=cuda)
    other = R.init_cache(cfg, 4, 16, device=cuda)
    toks = torch.randint(1, cfg.vocab, (4, 1), generator=gen, device=cuda,
                         dtype=torch.int32)
    with torch.inference_mode():
        for start in (0, 3):
            want, _ = eager(params, toks, cache, start)
            got, _ = graphed(params, toks, other, start)
            assert torch.equal(got, want), start
            for name in cache:
                assert torch.equal(other[name], cache[name]), start
    assert graphed.captured.captures == 1


def test_engine_on_card_serves_twice_through_one_capture(cuda):
    """Engine.warmup captures the tick on the engine's own cache; two
    serves then replay that one graph (the cache zeroed in place between
    them) and give the same tokens, equal to the reference."""
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = quantize_tree(R.init(gen, cfg, device=cuda), min_size=2048)
    reqs = E.synthetic_requests(8, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=5, max_new_tokens=4)
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=9,
                   prefill_chunk=4)
    eng.warmup()
    step = eng.backend.slot_step(cfg, mode=W8A16, temperature=0.0)
    captures = step.captured.captures
    first = eng.serve(reqs).outputs()
    assert eng.serve(reqs).outputs() == first
    assert step.captured.captures == captures
    assert first == E.reference_outputs(cfg, params, reqs, mode=W8A16,
                                        max_seq=eng.max_seq)


@pytest.mark.parametrize("kind", list(GRAPH_KINDS))
def test_captured_chunk_equals_per_token(cuda, kind):
    """The chunk step of slot 1 from position 6 (paged: across a block
    edge) for every n_valid of a chunk of 4: captured (one graph per
    n_valid) and eager, each cache leaf bitwise the eager per-token
    step's (which reads a contiguous slot row through the contiguous
    kernel) on copies of a cache with a history; a replay launches, under
    W8A16, the eager one pass's 6 x layers GEMVs and one paged attention
    launch a layer (a contiguous cache read through the slot's one-entry
    table), under W8A8 one pass per token."""
    cfg, params, mode, cache, _ = _graph_case(cuda, kind)
    per_token = ST.make_per_token_chunk_step(cfg, mode=mode, chunk=4)
    eager = ST.make_prefill_chunk_step(cfg, mode=mode, chunk=4)
    graphed = ST.jit_prefill_chunk_step(ST.make_prefill_chunk_step(
        cfg, mode=mode, chunk=4))
    toks = np.random.default_rng(9).integers(1, cfg.vocab, 4).astype(
        np.int32)
    one_pass = mode is W8A16
    with torch.inference_mode():
        for n in range(1, 5):
            want, one, got = _clone(cache), _clone(cache), _clone(cache)
            per_token(params, toks, want, 1, 6, n)
            _, per_eager = _counted_call(eager, params, toks, one, 1, 6, n)
            graphed(params, toks, got, 1, 6, n)           # the capture
            for name in got:                 # the captured tensors, reset
                got[name].copy_(cache[name])
            _, per_graph = _counted_call(graphed, params, toks, got, 1, 6, n)
            for name in cache:
                assert torch.equal(one[name], want[name]), (n, name)
                assert torch.equal(got[name], want[name]), (n, name)
            passes = 1 if one_pass else n
            if one_pass:
                assert per_graph == per_eager, n
            projections = 6 * cfg.n_layers * passes
            assert per_graph.get("qmatmul_w8a16[gemv]", 0) == (
                projections if one_pass else 0), n
            assert per_graph.get("qmatmul_w8a8", 0) == (
                0 if one_pass else projections), n
            if kind != "bf16":
                assert per_graph["decode_attention_int8_paged"] == \
                    cfg.n_layers * passes, n
    assert graphed.captured.captures == 4
    torch.cuda.synchronize()
    for pair in scratch._SCRATCH.values():
        assert not pair[1].any()


def test_engines_on_card_serving_in_turn_capture_once_each(cuda):
    """A contiguous and a paged engine of one config, warmed up, serve in
    turn: the memoized tick and chunk steps capture nothing more (each
    engine replays its own graphs), and both equal the reference."""
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    gen = torch.Generator(device=cuda).manual_seed(4)
    params = quantize_tree(R.init(gen, cfg, device=cuda), min_size=2048)
    reqs = E.synthetic_requests(8, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=7, max_new_tokens=4)
    engines = [E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=12,
                        prefill_chunk=4, block_size=bs) for bs in (None, 4)]
    for eng in engines:
        eng.warmup()
    steps = [engines[0].backend.slot_step(cfg, mode=W8A16, temperature=0.0)]
    steps += [engines[0].backend.chunk_step(cfg, mode=W8A16, chunk=c)
              for c in (1, 2, 4)]
    bound = [s.captured.captures for s in steps]
    want = E.reference_outputs(cfg, params, reqs, mode=W8A16, max_seq=12)
    for eng in engines + engines[:1]:
        assert eng.serve(reqs).outputs() == want
    assert [s.captured.captures for s in steps] == bound


def test_failed_capture_raises(cuda):
    """A step that waits for the card inside its capture raises
    GraphCaptureError and keeps no graph; nothing runs it eagerly
    instead.  In a process of its own: a failed capture may leave the
    CUDA context unusable."""
    code = r"""
import torch
from repro_torch.runtime import graphs as G
step = G.CapturedStep(lambda params, cache, x: (x * float(x.sum()),))
cache = {"k": torch.zeros(4, device="cuda")}
try:
    step({}, cache, torch.ones(4, device="cuda"))
except G.GraphCaptureError as e:
    assert step.bindings == 0
    print("raised:", type(e.__cause__).__name__)
else:
    raise SystemExit("no error")
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parents[1] / "src"),
         os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "raised:" in res.stdout, res.stderr


def _overload_captures(eng):
    steps = [eng.backend.slot_step(eng.cfg, mode=W8A16, temperature=0.0)]
    steps += [eng.backend.chunk_step(eng.cfg, mode=W8A16, chunk=c)
              for c in (1, 2, 4)]
    return [s.captured.captures for s in steps]


def test_paged_overload_serve_on_card_equals_control(cuda):
    """Reduced starcoder2-3b on the card, paged, two classes through a
    pool of 8 usable blocks against 12 worst-case: preemption and one
    fault of each kind (a dispatch fault retried twice, a non-finite
    sample, a torn block-table row torn in place).  Every fault fires,
    every request equals a control serve with neither (and the control
    the sequential reference), the resumes replay the warmed-up chunk
    graphs, and neither serve captures anything or reaches a plain
    version."""
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = quantize_tree(R.init(gen, cfg, device=cuda), min_size=2048)
    reqs = E.synthetic_requests(
        12, rate_per_s=500.0, vocab=cfg.vocab, prompt_len=6,
        max_new_tokens=6,
        priority=lambda rid: "batch" if rid % 2 else "interactive")
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=12,
                   prefill_chunk=4, block_size=4, num_blocks=9)
    eng.warmup()
    bound = _overload_captures(eng)
    table = eng.zeroed_cache()["block_tables"]
    control = eng.serve(reqs)
    plan = E.FaultPlan([E.Fault(tick=4, kind="dispatch", slot=1, repeat=2),
                        E.Fault(tick=6, kind="nan_logits", slot=2),
                        E.Fault(tick=8, kind="torn_table", slot=0)])
    A.decode_attention_int8_paged_ref.calls = K.qmatmul_w8a16_ref.calls = 0
    rep = eng.serve(reqs, preemption=True, fault_plan=plan)
    assert A.decode_attention_int8_paged_ref.calls == 0
    assert K.qmatmul_w8a16_ref.calls == 0
    assert _overload_captures(eng) == bound
    assert eng.zeroed_cache()["block_tables"] is table
    assert {kind for _, kind, _ in plan.fired} == {
        "dispatch", "nan_logits", "torn_table"}
    assert rep.dispatch_retries == 2 and rep.nonfinite_samples == 1
    assert rep.torn_rows_repaired == 1
    # at least one eviction by block pressure, besides the two repairs
    assert rep.preempted > rep.nonfinite_samples + rep.torn_rows_repaired
    assert rep.failed == 0 and rep.leaked_blocks == 0
    assert rep.outputs() == control.outputs()
    assert control.outputs() == E.reference_outputs(
        cfg, params, reqs, mode=W8A16, max_seq=eng.max_seq)


# ---------------------------------------------------------------------------
# temperature sampling and the captured service-curve forward
# ---------------------------------------------------------------------------

def test_prng_on_card_equals_cpu(cuda):
    """The threefry keys and draws on the card against the CPU's: fold_in
    over 4,096 positions, random_bits and uniform bitwise at the dense
    vocabularies, gumbel within 4 ulps of max(|g|, 1) (the bound of
    tests/test_torch_sampling.py)."""
    from repro_torch.runtime import prng as P
    tiny = float(torch.finfo(torch.float32).tiny)
    for seed in (0, 7):
        kc, kg = P.PRNGKey(seed), P.PRNGKey(seed, device=cuda)
        pos = torch.arange(4096, dtype=torch.int32)
        keys_c, keys_g = P.fold_in(kc, pos), P.fold_in(kg, pos.to(cuda))
        assert torch.equal(keys_g.cpu(), keys_c)
        for vocab in (49152, 131072, 152064):
            for c, g, shape in ((kc, kg, (2, vocab)),
                                (keys_c[:4], keys_g[:4], (4, vocab))):
                assert torch.equal(P.random_bits(g, shape).cpu(),
                                   P.random_bits(c, shape))
                assert torch.equal(
                    P.uniform(g, shape, tiny, 1.0).cpu().view(torch.int32),
                    P.uniform(c, shape, tiny, 1.0).view(torch.int32))
                gc = P.gumbel(c, shape).double()
                gg = P.gumbel(g, shape).cpu().double()
                unit = torch.from_numpy(np.spacing(np.maximum(
                    gc.abs().float().numpy(), np.float32(1))))
                assert ((gg - gc).abs() <= 4 * unit).all()


@pytest.mark.parametrize("vocab", [49152, 152064])
def test_sampled_rows_alone_equal_the_batch_on_card(cuda, vocab):
    """temperature_sample_rows on the card: each of 8 rows drawn alone
    (batch 1) equals the same row in the 8-row batch, bitwise."""
    from repro_torch.runtime import prng as P
    g = torch.Generator(device=cuda).manual_seed(vocab)
    logits = torch.randn((8, 1, vocab), generator=g, device=cuda) * 3
    keys = P.fold_in(P.PRNGKey(1, device=cuda),
                     torch.tensor([0, 5, 17, 99, 1023, 2048, 4000, 4095],
                                  device=cuda))
    with torch.inference_mode():
        batch = ST.temperature_sample_rows(logits, keys, 0.8)
        for r in range(8):
            one = ST.temperature_sample_rows(logits[r:r + 1], keys[r:r + 1],
                                             0.8)
            assert one[0] == batch[r], r


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_captured_sampled_tick_equals_eager(cuda, kind):
    """The sampled tick captured against eager over six ticks of the
    schedule: next tokens, indices and every cache leaf bitwise; one
    capture whatever the key (the key is a graph input)."""
    from repro_torch.runtime import prng as P
    cfg, params, mode, cache, sched = _graph_case(cuda, kind)
    eager = ST.make_slot_decode_step(cfg, mode=mode, temperature=0.8)
    graphed = ST.jit_slot_decode_step(ST.make_slot_decode_step(
        cfg, mode=mode, temperature=0.8))
    other = _clone(cache)
    with torch.inference_mode():
        for t, tick in enumerate(sched):
            key = P.PRNGKey(3 + t % 2, device=cuda)
            if tick["tables"] is not None:
                for c in (cache, other):
                    c["block_tables"].copy_(torch.from_numpy(tick["tables"]))
            args = tick_args(tick, cuda)
            n_e, _, i_e = eager(params, args[0], cache, args[1], args[2], key)
            n_g, _, i_g = graphed(params, args[0], other, args[1], args[2],
                                  key)
            assert torch.equal(n_g, n_e) and torch.equal(i_g, i_e), t
            for name in cache:
                assert torch.equal(other[name], cache[name]), (t, name)
    assert graphed.captured.captures == 1


def test_sampled_engine_on_card_equals_reference(cuda):
    """A sampled engine on the card (chunked prefill, paged) equals the
    sampled sequential reference under the same key, and serves through
    the graphs its warm-up captured."""
    from repro_torch.runtime import prng as P
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = quantize_tree(R.init(gen, cfg, device=cuda), min_size=2048)
    reqs = E.synthetic_requests(12, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=5, max_new_tokens=6)
    key = P.PRNGKey(9)
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=16,
                   prefill_chunk=4, block_size=4, temperature=0.8, rng=key)
    eng.warmup()
    step = eng.backend.slot_step(cfg, mode=W8A16, temperature=0.8)
    captures = step.captured.captures
    rep = eng.serve(reqs)
    assert step.captured.captures == captures
    assert rep.outputs() == E.reference_outputs(
        cfg, params, reqs, mode=W8A16, max_seq=eng.max_seq, temperature=0.8,
        rng=key)


@pytest.mark.parametrize("mode", [W8A16, W8A8, None],
                         ids=["w8a16", "w8a8", "fp"])
def test_captured_forward_equals_eager(cuda, mode):
    """The service curve's forward through ``jit_prefill_step`` at batches
    1, 4 and 16 of 32 tokens: the logits bitwise the eager forward's (the
    mma path's shared-memory setting made once, before any capture), a
    graph per batch, none more on a second pass."""
    from repro_torch.core.qlinear import FP
    cfg = get_config("starcoder2-3b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(4)
    params = R.init(gen, cfg, device=cuda)
    if mode is not None:
        params = quantize_tree(params, min_size=2048)
    eager = ST.make_prefill_step(cfg, mode=mode or FP)
    graphed = ST.jit_prefill_step(eager)
    with torch.inference_mode():
        for _ in range(2):
            for b in (1, 4, 16):
                toks = torch.randint(0, cfg.vocab, (b, 32), generator=gen,
                                     device=cuda, dtype=torch.int32)
                want = eager(params, {"tokens": toks})
                got = graphed(params, {"tokens": toks})
                assert torch.equal(got, want), b
    assert graphed.captured.captures == graphed.captured.bindings == 3


# the expert stacks' edges: one expert (the 2-D GEMV's launch), a stack
# whose plan splits K (a workspace share per expert), M across two row
# slabs, N % 16 == 4 (4-byte weight copies, a ragged strip), and
# qwen2-moe-a2.7b's gate, up and down shapes at a tick's 8 rows
EXPERT_CASES = ((1, 11, 264, 96), (6, 11, 512, 100), (16, 3, 128, 64),
                (60, 8, 2048, 1408), (60, 8, 1408, 2048))


@pytest.mark.parametrize("e,m,k,n", EXPERT_CASES)
def test_qmatmul_w8a16_experts_matches_plain(cuda, e, m, k, n):
    """The GEMV over a stack of experts against its plain version (silu
    drain and none, bf16 and f32 x and out), within ``_close``; a stack
    of one expert bitwise the 2-D GEMV's launch on it (a stack of E has
    its own split plan, so its rows may differ from that launch by f32
    rounding); expert 0's rows bitwise unchanged when the other experts'
    rows change; each row bitwise alone and in its batch."""
    g = torch.Generator(device=cuda).manual_seed(e + k)
    q = quantize_weight(torch.randn((e, k, n), generator=g, device=cuda))
    w, s = q.values, q.scale
    for x_dtype, out_dtype, act in ((torch.bfloat16, torch.bfloat16, "silu"),
                                    (torch.float32, torch.float32, "none")):
        x = torch.randn((e, m, k), generator=g, device=cuda).to(x_dtype)
        launches = K.qmatmul_w8a16_experts.launches
        got = K.qmatmul_w8a16_experts(x, w, s, activation=act,
                                      out_dtype=out_dtype)
        assert K.qmatmul_w8a16_experts.launches == launches + 1
        want = K.qmatmul_w8a16_experts_ref(x, w, s, activation=act,
                                           out_dtype=out_dtype)
        assert _close(got, want, out_dtype), (x_dtype, act)
        for i in range(0, e, max(1, e // 4)):
            one = K.qmatmul_w8a16_experts(x[i:i + 1].contiguous(), w[i:i + 1],
                                          s[i:i + 1], activation=act,
                                          out_dtype=out_dtype)
            assert torch.equal(one[0], K.qmatmul_w8a16(
                x[i], w[i], s[i].reshape(-1).contiguous(), activation=act,
                out_dtype=out_dtype)), i
        if e > 1:
            other = x.clone()
            other[1:] = torch.randn(other[1:].shape, generator=g,
                                    device=cuda).to(x_dtype)
            assert torch.equal(K.qmatmul_w8a16_experts(
                other, w, s, activation=act, out_dtype=out_dtype)[0], got[0])
        for r in (0, m - 1):
            one = K.qmatmul_w8a16_experts(x[:, r:r + 1].contiguous(), w, s,
                                          activation=act,
                                          out_dtype=out_dtype)
            assert torch.equal(one[:, 0], got[:, r]), r


def _masks(e, m, g, device):
    """A live mask of (E, M) flags: each row live with probability 1/2,
    expert 0 all dead, expert 1 all live but for its second 8-row slab
    (where it has one), so the launch has dead slabs of a live expert."""
    live = (torch.rand((e, m), generator=g, device=device) < 0.5).to(
        torch.uint8)
    live[0] = 0
    if e > 1:
        live[1] = 1
        live[1, 8:16] = 0
    return live


def _zero_dead(x, live):
    """x with its dead rows +0, as the dispatch stack holds them."""
    return torch.where(live.bool()[..., None], x, torch.zeros(
        (), dtype=x.dtype, device=x.device))


def _routed_stack(g, device):
    """qwen2-moe-a2.7b's tick stack as ``moe_ffn`` builds it: 8 tokens
    routed by a random int8 router through ``moe.route``/``dispatch``
    (capacity 1), scattered into the (60, 8, 2048) dispatch stack, and
    ``moe.live_rows`` of it."""
    from repro_torch.models import moe as M
    c = get_config("qwen2-moe-a2.7b")
    e, d, k = c.n_experts, c.d_model, c.top_k
    router = {"w": quantize_weight(torch.randn(
        (d, e), generator=g, device=device) * d ** -0.5)}
    x = torch.randn((8, 1, d), generator=g, device=device).to(torch.bfloat16)
    _, top_e = M.route(router, x, k)
    place, keep = M.dispatch(top_e, 1, e)
    buf = x.new_zeros((e * 8 + 1, d))
    buf.index_copy_(0, torch.where(keep, place, e * 8).reshape(-1),
                    x.repeat_interleave(k, dim=1).reshape(-1, d))
    return buf[:e * 8].view(e, 8, d), M.live_rows(place, keep, e, 8)


# the live mask's cases: EXPERT_CASES under a random mask, and the routed
# (60, 8) stack of a tick at w_gate's shape
MASK_CASES = EXPERT_CASES + ((60, 8, 2048, 1408, "routed"),)
# (x, out, activation) of the masked launches: the gate's silu, sigmoid
# (whose act(+0.0) is 0.5; bf16 out, as an f32 sigmoid's slope near 0 is
# steeper than _close's f32 tolerance allows at K = 2048) and none in f32
LIVE_DRAINS = ((torch.bfloat16, torch.bfloat16, "silu"),
               (torch.float32, torch.bfloat16, "sigmoid"),
               (torch.float32, torch.float32, "none"))


@pytest.mark.parametrize("case", MASK_CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}x{c[3]}"
                              + ("-routed" if len(c) > 4 else "")
                              for c in MASK_CASES])
def test_qmatmul_w8a16_experts_live_mask(cuda, case):
    """The GEMV over a stack with a live mask: where the dead rows of x
    are zero (the dispatch stack's case) every row bitwise the launch
    without the mask and within ``_close`` of the plain version; a dead
    slab's tile act(+0.0) (sigmoid: 0.5); where the dead rows of x are
    not zero, the live rows bitwise unchanged and the dead ones act(+0.0);
    each row bitwise alone (its own flag) and in its batch; the arrival
    counters 0 after a masked launch whose plan splits K."""
    e, m, k, n = case[:4]
    g = torch.Generator(device=cuda).manual_seed(3 * e + k)
    q = quantize_weight(torch.randn((e, k, n), generator=g, device=cuda))
    w, s = q.values, q.scale
    if len(case) > 4:
        x0, live = _routed_stack(g, cuda)
        assert 0 < int(live.any(1).sum()) < e
    else:
        live = _masks(e, m, g, cuda)
    plan = K.gemv_experts_plan(e, k, n)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for x_dtype, out_dtype, act in LIVE_DRAINS:
        if len(case) > 4:
            x = x0.to(x_dtype)
        else:
            x = torch.randn((e, m, k), generator=g, device=cuda).to(x_dtype)
        zeroed = _zero_dead(x, live)
        kw = dict(activation=act, out_dtype=out_dtype)
        got = K.qmatmul_w8a16_experts(zeroed, w, s, live=live, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, K.qmatmul_w8a16_experts(zeroed, w, s, **kw))
        assert _close(got, K.qmatmul_w8a16_experts_ref(
            zeroed, w, s, live=live, **kw), out_dtype)
        dead = torch.full((), 0.5 if act == "sigmoid" else 0.0,
                          device=cuda).to(out_dtype)
        assert (got[~live.bool()] == dead).all()
        if len(case) == 4:
            assert (got[0] == dead).all()         # expert 0: dead slabs
        if plan.splits > 1:
            assert (scratch.held(x.device, stream)[1] == 0).all()
        noisy = K.qmatmul_w8a16_experts(x, w, s, live=live, **kw)
        full = K.qmatmul_w8a16_experts(x, w, s, **kw)
        mask = live.bool()
        assert torch.equal(noisy[mask], full[mask])
        assert (noisy[~mask] == dead).all()
        for r in (0, m - 1):
            one = K.qmatmul_w8a16_experts(
                x[:, r:r + 1].contiguous(), w, s,
                live=live[:, r:r + 1].contiguous(), **kw)
            assert torch.equal(one[:, 0], noisy[:, r]), r


# the tensor-core entry's stacks: the serve CLI curve's 3, 12 and 48 rows
# an expert, a stack across two 64-row tiles, N % 16 == 4 (4-byte weight
# copies, a ragged strip), K % 128 == 16 (a ragged last stage)
MMA_EXPERT_CASES = ((6, 3, 272, 100), (6, 12, 528, 264), (6, 48, 1408, 512),
                    (4, 65, 272, 260), (3, 48, 2048, 1408))


@pytest.mark.parametrize("e,m,k,n", MMA_EXPERT_CASES)
def test_qmatmul_w8a16_experts_mma_matches_plain(cuda, e, m, k, n):
    """The tensor-core kernel over a stack of experts (``path="mma"``)
    within ``_close`` of the plain version (LIVE_DRAINS' activations and
    out types); each row bitwise alone and in its batch; a stack of one
    bitwise ``qmatmul_w8a16_on_path("mma")`` on that expert; with a live
    mask bitwise the unmasked launch where the dead rows are zero, a dead
    tile act(+0.0); counted on its path."""
    g = torch.Generator(device=cuda).manual_seed(e + m + k)
    q = quantize_weight(torch.randn((e, k, n), generator=g, device=cuda))
    w, s = q.values, q.scale
    x = torch.randn((e, m, k), generator=g, device=cuda).to(torch.bfloat16)
    for _, out_dtype, act in LIVE_DRAINS:
        kw = dict(activation=act, out_dtype=out_dtype)
        before = dict(K.qmatmul_w8a16_experts.launches_by_path)
        got = K.qmatmul_w8a16_experts(x, w, s, path="mma", **kw)
        torch.cuda.synchronize()
        assert K.qmatmul_w8a16_experts.launches_by_path == dict(
            before, mma=before["mma"] + 1)
        assert _close(got, K.qmatmul_w8a16_experts_ref(x, w, s, **kw),
                      out_dtype), act
        for r in (0, m // 2, m - 1):
            one = K.qmatmul_w8a16_experts(x[:, r:r + 1].contiguous(), w, s,
                                          path="mma", **kw)
            assert torch.equal(one[:, 0], got[:, r]), r
        for i in range(e):
            one = K.qmatmul_w8a16_experts(x[i:i + 1].contiguous(),
                                          w[i:i + 1], s[i:i + 1],
                                          path="mma", **kw)
            assert torch.equal(one[0], K.qmatmul_w8a16_on_path(
                "mma", x[i], w[i], s[i].reshape(-1).contiguous(),
                **kw)), i
        live = _masks(e, m, g, cuda)
        zeroed = _zero_dead(x, live)
        masked = K.qmatmul_w8a16_experts(zeroed, w, s, live=live,
                                         path="mma", **kw)
        assert torch.equal(masked, K.qmatmul_w8a16_experts(
            zeroed, w, s, path="mma", **kw))
        dead = torch.full((), 0.5 if act == "sigmoid" else 0.0,
                          device=cuda).to(out_dtype)
        assert (masked[0] == dead).all()
        assert (K.qmatmul_w8a16_experts(x, w, s, live=live, path="mma",
                                        **kw)[~live.bool()] == dead).all()
    with pytest.raises(ValueError, match="bf16"):
        K.qmatmul_w8a16_experts(x.float(), w, s, path="mma")


def test_moe_forward_takes_the_experts_mma_path(cuda):
    """Reduced qwen2-moe-a2.7b on the card: the W8A16 forward launches
    the experts' tensor-core kernel, three stacks a layer, and no GEMV
    stack; a decode step the GEMV stacks only; the logits finite."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              n_experts=16, top_k=4, n_heads=16,
                              n_kv_heads=16, d_ff=64, capacity_factor=1.25)
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = R.init_quantized(gen, cfg, device=cuda)
    toks = torch.randint(1, cfg.vocab, (2, 12), generator=gen, device=cuda,
                         dtype=torch.int32)
    before = dict(K.qmatmul_w8a16_experts.launches_by_path)
    with torch.inference_mode():
        logits = ST.make_prefill_step(cfg, mode=W8A16)(params,
                                                       {"tokens": toks})
        torch.cuda.synchronize()
        mid = dict(K.qmatmul_w8a16_experts.launches_by_path)
        ST.make_decode_step(cfg, mode=W8A16)(
            params, {"tokens": toks[:, :1], "cache_index": 3},
            R.init_cache(cfg, 2, 16, device=cuda))
        torch.cuda.synchronize()
    after = K.qmatmul_w8a16_experts.launches_by_path
    assert mid == dict(before, mma=before["mma"] + 3 * cfg.n_layers)
    assert after == dict(mid, gemv=mid["gemv"] + 3 * cfg.n_layers)
    assert torch.isfinite(logits).all()


def test_sampled_moe_engine_on_card_equals_reference(cuda):
    """Reduced qwen2-moe-a2.7b sampled on the card (t = 0.8, chunked
    prefill, contiguous and paged): every token equal to the sampled
    sequential reference under the same key."""
    from repro_torch.runtime import prng as P
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              n_experts=16, top_k=4, n_heads=16,
                              n_kv_heads=16, d_ff=64, capacity_factor=1.25)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = R.init_quantized(gen, cfg, device=cuda)
    reqs = E.synthetic_requests(8, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=6, max_new_tokens=5,
                                shared_prefix_len=4)
    key = P.PRNGKey(3)
    want = E.reference_outputs(cfg, params, reqs, mode=W8A16, max_seq=16,
                               temperature=0.8, rng=key)
    for paged in ({}, dict(block_size=4, num_blocks=10)):
        eng = E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=16,
                       prefill_chunk=4, temperature=0.8, rng=key, **paged)
        assert eng.serve(reqs).outputs() == want, paged


def test_moe_route_rows_are_batch_invariant_on_card(cuda):
    """The router's softmax, the stable top-k and the renormalisation of
    qwen2-moe-a2.7b's 60 experts: each row's bits alone equal its bits in
    a batch of 16, and ties go to the lower expert index."""
    from repro_torch.models import moe as M
    g = torch.Generator(device=cuda).manual_seed(2)
    q = quantize_weight(torch.randn((2048, 60), generator=g, device=cuda)
                        * 2048 ** -0.5)
    x = torch.randn((16, 1, 2048), generator=g, device=cuda).to(
        torch.bfloat16)
    top_p, top_e = M.route({"w": q}, x, 4)
    for r in range(16):
        p1, e1 = M.route({"w": q}, x[r:r + 1], 4)
        assert torch.equal(p1[0], top_p[r]) and torch.equal(e1[0], top_e[r])
    _, ties = M.route({"w": torch.zeros((2048, 60), device=cuda)}, x, 4)
    assert (ties == torch.arange(4, device=cuda)).all()


def test_moe_engines_on_card_equal_reference(cuda):
    """Reduced qwen2-moe-a2.7b with its int8 router (16 experts, top-4,
    G = 1) on the card, weights from the streamed init: 12 requests
    through 4 slots with chunked prefill (one causal pass a chunk, every
    token routed alone), contiguous and paged on the bf16 cache and
    contiguous on the int8 cache, every token equal to the sequential
    batch-1 reference, the experts' GEMV launched, no block leaked."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              n_experts=16, top_k=4, n_heads=16,
                              n_kv_heads=16, d_ff=64, capacity_factor=1.25)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = R.init_quantized(gen, cfg, device=cuda)
    assert isinstance(params["layers"][0]["moe"]["router"]["w"], QTensor)
    reqs = E.synthetic_requests(12, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=6, max_new_tokens=5,
                                shared_prefix_len=4)
    kw = dict(mode=W8A16, num_slots=4, max_seq=16, prefill_chunk=4)
    want = E.reference_outputs(cfg, params, reqs, mode=W8A16, max_seq=16)
    launches = K.qmatmul_w8a16_experts.launches
    assert E.Engine(cfg, params, **kw).serve(reqs).outputs() == want
    assert K.qmatmul_w8a16_experts.launches > launches
    rep = E.Engine(cfg, params, block_size=4, num_blocks=10,
                   **kw).serve(reqs)
    assert rep.outputs() == want
    assert rep.leaked_blocks == 0 and rep.shared_block_hits > 0
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    assert E.Engine(qcfg, params, **kw).serve(reqs).outputs() == \
        E.reference_outputs(qcfg, params, reqs, mode=W8A16, max_seq=16)


# ---------------------------------------------------------------------------
# speculative decoding: the captured verify and propose steps
# ---------------------------------------------------------------------------

SPEC_K = 3


def _verify_rounds(sched, vocab, seed=0, max_seq=16):
    """A verify round per tick of the schedule: each row's next input and
    k proposals (random), each row feeding its own count of them (one
    row at 1, its next input alone), inactive rows as the tick's; every
    row's index at most max_seq - k - 2, so that its writes (up to its
    frozen frontier, index + n_tok) stay inside the row."""
    rng = np.random.default_rng(seed)
    rounds = []
    for t, tick in enumerate(sched):
        n_tok = ((np.arange(len(tick["active"])) + t) % (SPEC_K + 1)
                 + 1).astype(np.int32)
        index = np.minimum(tick["index"], max_seq - SPEC_K - 2)
        rounds.append(dict(tick, n_tok=n_tok, index=index,
                           tokens=rng.integers(1, vocab, (
                               len(n_tok), SPEC_K + 1)).astype(np.int32)))
    return rounds


def _round_args(rnd, device):
    return tuple(torch.from_numpy(rnd[k]).to(device)
                 for k in ("tokens", "index", "n_tok", "active"))


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_captured_verify_equals_eager(cuda, kind, sampled):
    """The verify step captured as one graph against its eager form over
    six rounds (rows retiring and admitted between them; paged: table
    rows changed in place): samples, indices and every cache leaf
    bitwise; one capture, whatever the round's counts and key."""
    from repro_torch.runtime import prng as P
    cfg, params, mode, cache, sched = _graph_case(cuda, kind)
    t = 0.8 if sampled else 0.0
    eager = ST.make_verify_step(cfg, mode=mode, k=SPEC_K, temperature=t)
    graphed = ST.jit_verify_step(ST.make_verify_step(
        cfg, mode=mode, k=SPEC_K, temperature=t))
    other = _clone(cache)
    with torch.inference_mode():
        for i, rnd in enumerate(_verify_rounds(sched, cfg.vocab)):
            keys = (P.PRNGKey(3 + i % 2, device=cuda),) if sampled else ()
            if rnd["tables"] is not None:
                for c in (cache, other):
                    c["block_tables"].copy_(torch.from_numpy(rnd["tables"]))
            args = _round_args(rnd, cuda)
            s_e, _, i_e = eager(params, args[0], cache, *args[1:], *keys)
            s_g, _, i_g = graphed(params, args[0], other, *args[1:], *keys)
            assert torch.equal(s_g, s_e) and torch.equal(i_g, i_e), i
            for name in cache:
                assert torch.equal(other[name], cache[name]), (i, name)
    assert graphed.captured.captures == 1


def test_captured_propose_equals_eager(cuda):
    """The propose step captured against eager over six rounds: the
    proposals, indices and every cache leaf bitwise; one capture."""
    cfg, params, mode, cache, sched = _graph_case(cuda, "contiguous")
    eager = ST.make_draft_propose_step(cfg, mode=mode, k=SPEC_K)
    graphed = ST.jit_draft_propose_step(ST.make_draft_propose_step(
        cfg, mode=mode, k=SPEC_K))
    other = _clone(cache)
    with torch.inference_mode():
        for i, rnd in enumerate(_verify_rounds(sched, cfg.vocab)):
            tokens, index, _, active = _round_args(rnd, cuda)
            tok = tokens[:, :1].contiguous()
            p_e, _, i_e = eager(params, tok, cache, index, active)
            p_g, _, i_g = graphed(params, tok, other, index, active)
            assert torch.equal(p_g, p_e) and torch.equal(i_g, i_e), i
            for name in cache:
                assert torch.equal(other[name], cache[name]), (i, name)
    assert graphed.captured.captures == 1


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_captured_verify_equals_k_plus_1_captured_ticks(cuda, kind):
    """The captured verify step against k + 1 replays of the captured
    slot tick (position j active where j < n_tokens) on a copy of the
    cache: samples, indices and every cache leaf bitwise."""
    cfg, params, mode, cache, sched = _graph_case(cuda, kind)
    verify = ST.jit_verify_step(ST.make_verify_step(cfg, mode=mode,
                                                    k=SPEC_K))
    tick = ST.jit_slot_decode_step(ST.make_slot_decode_step(cfg, mode=mode))
    other = _clone(cache)
    col = torch.empty((4, 1), dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        for i, rnd in enumerate(_verify_rounds(sched, cfg.vocab, seed=1)):
            if rnd["tables"] is not None:
                for c in (cache, other):
                    c["block_tables"].copy_(torch.from_numpy(rnd["tables"]))
            tokens, index, n_tok, active = _round_args(rnd, cuda)
            s_v, _, i_v = verify(params, tokens, cache, index, n_tok, active)
            idx, samples = index, []
            for j in range(SPEC_K + 1):
                col.copy_(tokens[:, j:j + 1])
                nxt, _, idx = tick(params, col, other, idx,
                                   active & (n_tok > j))
                samples.append(nxt.clone())
                idx = idx.clone()
            assert torch.equal(s_v, torch.stack(samples, 1)), i
            assert torch.equal(i_v, idx), i
            for name in cache:
                assert torch.equal(other[name], cache[name]), (i, name)
    assert verify.captured.captures == tick.captured.captures == 1


def test_speculative_engine_on_card_equals_control(cuda):
    """Reduced starcoder2-3b on the card, int8 cache, paged, chunked
    prefill: a speculating engine (1-layer self-draft, k = 3; greedy and
    sampled) equals its non-speculative control and the sequential
    reference, serving through the graphs its warm-up captured (a second
    serve captures none)."""
    from repro_torch.runtime import prng as P
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = quantize_tree(R.init(gen, cfg, device=cuda), min_size=2048)
    reqs = E.synthetic_requests(16, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=6, max_new_tokens=8,
                                shared_prefix_len=4)
    for t, key in ((0.0, None), (0.8, P.PRNGKey(9))):
        kw = dict(mode=W8A16, num_slots=4, max_seq=16, prefill_chunk=4,
                  block_size=4, temperature=t, rng=key)
        control = E.Engine(cfg, params, **kw).serve(reqs)
        eng = E.Engine(cfg, params, spec_k=SPEC_K, draft_layers=1, **kw)
        eng.warmup()
        be = eng.backend
        steps = [be.verify_step(cfg, mode=W8A16, k=SPEC_K, temperature=t),
                 be.propose_step(eng.dcfg, mode=W8A16, k=SPEC_K),
                 be.chunk_step(eng.dcfg, mode=W8A16, chunk=4)]
        bound = [s.captured.captures for s in steps]
        rep = eng.serve(reqs)
        assert rep.outputs() == eng.serve(reqs).outputs()
        assert [s.captured.captures for s in steps] == bound
        assert rep.outputs() == control.outputs() == E.reference_outputs(
            cfg, params, reqs, mode=W8A16, max_seq=eng.max_seq,
            temperature=t, rng=key)
        assert rep.leaked_blocks == 0
        if not t:
            assert rep.accepted_per_dispatch > 1.0


# ---------------------------------------------------------------------------
# the encdec family (whisper-medium): prime, cross-attention, padded head
# ---------------------------------------------------------------------------

def _whisper(cuda):
    cfg = get_config("whisper-medium").reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    return cfg, R.init_quantized(gen, cfg, device=cuda)


def test_encdec_captured_prime_equals_eager(cuda):
    """Reduced whisper-medium on the card: the captured prime (one graph
    for every slot) writes what the eager prime writes, every leaf
    bitwise, the encoder's projections on the mma path and its attention
    through flash_attention_bhsd."""
    cfg, params = _whisper(cuda)
    eager = ST.make_prime_step(cfg, mode=W8A16)
    graphed = ST.jit_prime_step(eager)
    a = R.init_cache(cfg, 4, 16, device=cuda)
    b = R.init_cache(cfg, 4, 16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    mma, flash = (K.qmatmul_w8a16.launches_by_path["mma"],
                  FA.flash_attention_bhsd.launches)
    for sid, n in ((2, 16), (0, 9), (3, 1)):
        src = torch.randn((1, cfg.enc_seq, cfg.d_model), generator=g,
                          device=cuda).to(torch.bfloat16)
        eager(params, src, a, sid, n)
        graphed(params, src.cpu(), b, sid, n)
    torch.cuda.synchronize()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert graphed.captured.captures == 1
    assert a["xlen"].tolist() == [9, cfg.enc_seq, 16, 1]
    assert K.qmatmul_w8a16.launches_by_path["mma"] > mma
    assert FA.flash_attention_bhsd.launches > flash


@pytest.mark.parametrize("se", [16, 1500])
def test_cross_attention_rows_alone_equal_the_batch_on_card(cuda, se):
    """The plain cross-attention's rows on the card do not depend on the
    batch (``tree_sum``, a row-wise softmax): each of 8 rows alone equals
    its row of the batch, bitwise, at whisper's 16 heads of 64."""
    g = torch.Generator(device=cuda).manual_seed(se)
    q = torch.randn((8, 1, 16, 64), generator=g, device=cuda).to(
        torch.bfloat16)
    xk, xv = (torch.randn((8, se, 16, 64), generator=g, device=cuda)
              .to(torch.bfloat16) for _ in range(2))
    xlen = torch.tensor([se, se - 1, 1, se // 2, se, 3, se - 2, 7],
                        dtype=torch.int32, device=cuda).clamp_min(1)
    full = L.cross_cache_attention(q, xk, xv, xlen)
    for r in range(8):
        one = L.cross_cache_attention(q[r:r + 1], xk[r:r + 1], xv[r:r + 1],
                                      xlen[r:r + 1])
        assert torch.equal(one[0], full[r]), r
    want = L.cross_cache_attention(q.cpu(), xk.cpu(), xv.cpu(), xlen.cpu())
    torch.testing.assert_close(full.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vocab", [515, 51865])
def test_padded_lm_head_on_card(cuda, vocab):
    """A vocabulary that is no multiple of 4 runs through the W8A16
    kernels on a head padded with zero columns: both paths' logits are
    (.., V), within bf16_close-style f32 tolerance of the unpadded head's
    plain version."""
    g = torch.Generator(device=cuda).manual_seed(vocab)
    d = 256
    table = quantize_tree({"t": {"table": torch.randn(
        (vocab, d), generator=g, device=cuda) * d ** -0.5}},
        min_size=2048)["t"]
    x = torch.randn((8, d), generator=g, device=cuda).to(torch.bfloat16)
    want = K.qmatmul_w8a16_ref(x, table["table"].values.t().contiguous(),
                               table["table"].scale.reshape(-1),
                               out_dtype=torch.float32)
    for path in K.W8A16_PATHS:
        got = L.unembed(table, x, path=path)
        assert got.shape == (8, vocab)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_encdec_engine_on_card_equals_reference(cuda, kind):
    """Reduced whisper-medium on the card: 10 requests with their own
    frames (16, 15 or 14 long) through 4 slots with chunked prefill, each
    primed at admission, greedy and sampled, every token equal to the
    sequential batch-1 reference."""
    from repro_torch.runtime import prng as P
    cfg, params = _whisper(cuda)
    reqs = E.synthetic_requests(10, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=6, max_new_tokens=5,
                                source_shape=R.source_shape(cfg))
    paged = dict(block_size=4) if kind == "paged" else {}
    for t, key in ((0.0, None), (0.8, P.PRNGKey(3))):
        eng = E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=16,
                       prefill_chunk=4, temperature=t, rng=key, **paged)
        eng.warmup()
        rep = eng.serve(reqs)
        assert rep.outputs() == E.reference_outputs(
            cfg, params, reqs, mode=W8A16, max_seq=16, temperature=t,
            rng=key)
        assert rep.leaked_blocks == 0


def _mamba(cuda):
    cfg = get_config("mamba2-1.3b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    return cfg, R.init_quantized(gen, cfg, device=cuda)


def test_ssm_engine_on_card_equals_reference(cuda):
    """Reduced mamba2-1.3b on the card: 16 requests through 4 slots
    (slot reuse), with and without chunked prefill, greedy and sampled,
    every token equal to the sequential batch-1 reference."""
    from repro_torch.runtime import prng as P
    cfg, params = _mamba(cuda)
    reqs = E.synthetic_requests(16, rate_per_s=3000.0, vocab=cfg.vocab,
                                prompt_len=6, max_new_tokens=5)
    for chunk in (4, None):
        for t, key in ((0.0, None), (0.8, P.PRNGKey(3))):
            eng = E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=16,
                           prefill_chunk=chunk, temperature=t, rng=key)
            eng.warmup()
            rep = eng.serve(reqs)
            assert rep.outputs() == E.reference_outputs(
                cfg, params, reqs, mode=W8A16, max_seq=16, temperature=t,
                rng=key)
            assert {r.slot for r in rep.results} == set(range(4))


def test_ssm_captured_tick_freezes_inactive_rows_on_card(cuda):
    """The captured ssm tick on the card: bitwise the eager tick, inactive
    rows' h and conv bitwise unchanged (one of them at index 0, so not
    scrubbed), and a new tenant at index 0 decoding as in a fresh pool."""
    cfg, params = _mamba(cuda)
    S = 4
    eager = ST.make_slot_decode_step(cfg, mode=W8A16)
    graphed = ST.jit_slot_decode_step(ST.make_slot_decode_step(
        cfg, mode=W8A16))
    g = torch.Generator(device=cuda).manual_seed(1)
    cache = R.init_cache(cfg, S, 16, device=cuda)
    cache["h"].normal_(generator=g)
    cache["conv"].copy_(torch.randn(cache["conv"].shape, generator=g,
                                    device=cuda))
    toks = torch.tensor([[5], [1], [9], [2]], dtype=torch.int32, device=cuda)
    idx = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device=cuda)
    active = torch.tensor([True, False, True, False], device=cuda)
    want = {k: v.clone() for k, v in cache.items()}
    got = {k: v.clone() for k, v in cache.items()}
    n_e = eager(params, toks, want, idx, active)[0].clone()
    n_g = graphed(params, toks, got, idx, active)[0].clone()
    assert torch.equal(n_e, n_g)
    for k in cache:
        assert torch.equal(got[k], want[k])
        assert torch.equal(got[k][:, ~active], cache[k][:, ~active])
    only1 = torch.tensor([False, True, False, False], device=cuda)
    zero = torch.zeros((S,), dtype=torch.int32, device=cuda)
    fresh = R.init_cache(cfg, S, 16, device=cuda)
    a = graphed(params, toks, got, zero, only1)[0].clone()
    b = eager(params, toks, fresh, zero, only1)[0].clone()
    assert int(a[1]) == int(b[1])
    for k in cache:
        assert torch.equal(got[k][:, 1], fresh[k][:, 1])


def test_hybrid_engine_on_card_equals_reference(cuda):
    """Reduced recurrentgemma-9b on the card (8 layers: 2 groups and 2
    leftover recurrent blocks; a 32-slot ring): 8 requests of 24 + 12
    tokens (every one past the window) through 4 slots, with and without
    chunked prefill, greedy and sampled, every token equal to the
    sequential batch-1 reference."""
    from repro_torch.runtime import prng as P
    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              n_layers=8)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = R.init_quantized(gen, cfg, device=cuda)
    reqs = E.synthetic_requests(8, rate_per_s=3000.0, vocab=cfg.vocab,
                                prompt_len=24, max_new_tokens=12)
    for chunk in (4, None):
        for t, key in ((0.0, None), (0.8, P.PRNGKey(3))):
            eng = E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=48,
                           prefill_chunk=chunk, temperature=t, rng=key)
            eng.warmup()
            rep = eng.serve(reqs)
            assert rep.outputs() == E.reference_outputs(
                cfg, params, reqs, mode=W8A16, max_seq=48, temperature=t,
                rng=key)


def _mixtral_ring(cuda):
    """Reduced mixtral-8x22b at the full model's G = 6 and head_dim 128
    (12 query and 2 KV heads) and window 4,096, an int8 ring, int8
    weights from the streamed init."""
    cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(),
                              n_heads=12, n_kv_heads=2, head_dim=128,
                              window=4096, kv_quant=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    return cfg, R.init_quantized(gen, cfg, device=cuda)


def test_mixtral_ring_tick_on_card_equals_rows_alone(cuda):
    """Reduced mixtral on the card at G = 6 over a 4,096-slot int8 ring
    (max_seq 8,192) filled at random: 8 rows at positions 4,093-4,100
    (across the ring's end) through the captured tick, bitwise the eager
    tick (tokens and cache), each row's logits and leaves bitwise its
    batch-1 step; a replay launches the contiguous decode attention kernel
    once a layer.  Then the captured chunk step of slot 3 from 4,094
    (across the end) bitwise the per-token steps."""
    cfg, params = _mixtral_ring(cuda)
    S, pos = 8, list(range(4093, 4101))
    g = torch.Generator(device=cuda).manual_seed(1)
    cache = R.init_cache(cfg, S, 8192, device=cuda)
    assert cache["k"].shape[2] == 4096
    for k, t in cache.items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device=cuda, dtype=torch.int8))
        else:
            t.copy_(torch.rand(t.shape, generator=g, device=cuda) * 0.04
                    + 0.005)
    toks = torch.randint(1, cfg.vocab, (S, 1), generator=g, device=cuda,
                         dtype=torch.int32)
    idx = torch.tensor(pos, dtype=torch.int32, device=cuda)
    active = torch.ones((S,), dtype=torch.bool, device=cuda)
    eager = ST.make_slot_decode_step(cfg, mode=W8A16)
    graphed = ST.jit_slot_decode_step(ST.make_slot_decode_step(
        cfg, mode=W8A16))
    want, got = _clone(cache), _clone(cache)
    n_e = eager(params, toks, want, idx, active)[0].clone()
    n_g = graphed(params, toks, got, idx, active)[0].clone()
    assert torch.equal(n_e, n_g)
    for k in cache:
        assert torch.equal(got[k], want[k]), k
    decode = ST.make_decode_step(cfg, mode=W8A16)
    full = _clone(cache)
    logits, _ = decode(params, {"tokens": toks, "cache_index": idx}, full)
    for r, p in enumerate(pos):
        row = {k: v[:, r:r + 1].clone() for k, v in cache.items()}
        one, _ = decode(params, {"tokens": toks[r:r + 1],
                                 "cache_index": p}, row)
        assert torch.equal(one[0], logits[r]), r
        for k in row:
            assert torch.equal(row[k], full[k][:, r:r + 1]), (r, k)
    # a replay of the binding captured above
    _, launched = _counted_call(graphed, params, toks, got, idx, active)
    assert launched["decode_attention_int8"] == cfg.n_layers
    assert "decode_attention_int8_paged" not in launched     # zeros left out
    chunk = ST.jit_prefill_chunk_step(
        ST.make_prefill_chunk_step(cfg, mode=W8A16, chunk=4))
    per_token = ST.make_per_token_chunk_step(cfg, mode=W8A16, chunk=4)
    a, b = _clone(cache), _clone(cache)
    chunk(params, [5, 6, 7, 8], a, 3, 4094, 4)
    per_token(params, [5, 6, 7, 8], b, 3, 4094, 4)
    for k in cache:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the vlm family (llama-3.2-vision-90b): prime, engine, one-pass chunk
# ---------------------------------------------------------------------------

def _vlm(cuda):
    """Reduced llama-3.2-vision-90b on the card at 5 layers (two groups
    and a leftover layer), the full model's head_dim 128 (8 query, 2 KV
    heads) and 1,601 patches, int8 weights from the streamed init, every
    x_gate set to 0.5 (its zero init would keep the patches from the
    logits)."""
    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b").reduced(),
                              n_layers=5, n_heads=8, n_kv_heads=2,
                              head_dim=128, n_patches=1601)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = R.init_quantized(gen, cfg, device=cuda)
    for lp in params["layers"]:
        if "x_gate" in lp:
            lp["x_gate"].fill_(0.5)
    return cfg, params


def test_vlm_captured_prime_equals_eager(cuda):
    """The captured vlm prime (one graph for every slot) writes what the
    eager prime writes, every leaf bitwise, the two groups' wk / wv over
    1,601 patches on the mma path (no attention); two sources' primed
    rows give other logits for the same token."""
    cfg, params = _vlm(cuda)
    eager = ST.make_prime_step(cfg, mode=W8A16)
    graphed = ST.jit_prime_step(eager)
    a = R.init_cache(cfg, 4, 16, device=cuda)
    b = R.init_cache(cfg, 4, 16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    mma, flash = (K.qmatmul_w8a16.launches_by_path["mma"],
                  FA.flash_attention_bhsd.launches)
    for sid, n in ((2, 1601), (0, 1600), (3, 1)):
        src = torch.randn((1, cfg.n_patches, cfg.d_model), generator=g,
                          device=cuda).to(torch.bfloat16)
        src[:, n:] = 0
        eager(params, src, a, sid, n)
        graphed(params, src.cpu(), b, sid, n)
    torch.cuda.synchronize()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert graphed.captured.captures == 1
    assert a["xlen"].tolist() == [1600, 1601, 1601, 1]
    assert K.qmatmul_w8a16.launches_by_path["mma"] > mma
    assert FA.flash_attention_bhsd.launches == flash
    decode = ST.make_decode_step(cfg, mode=W8A16)
    toks = torch.full((4, 1), 5, dtype=torch.int32, device=cuda)
    logits, _ = decode(params, {"tokens": toks, "cache_index": torch.zeros(
        (4,), dtype=torch.int32, device=cuda)}, _clone(a))
    assert not torch.equal(logits[0], logits[2])


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_vlm_engine_on_card_equals_reference(cuda, kind):
    """Reduced vlm on the card: 10 requests with their own patches (1,601,
    1,600 or 1,599) through 4 slots with chunked prefill (the W8A16 chunk
    in one causal pass), each primed at admission, every token equal to
    the sequential batch-1 reference; then the captured one-pass chunk of
    a primed slot bitwise the per-token steps."""
    cfg, params = _vlm(cuda)
    reqs = E.synthetic_requests(10, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=6, max_new_tokens=5,
                                source_shape=R.source_shape(cfg))
    paged = dict(block_size=4) if kind == "paged" else {}
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=16,
                   prefill_chunk=4, **paged)
    eng.warmup()
    rep = eng.serve(reqs)
    assert rep.outputs() == E.reference_outputs(cfg, params, reqs,
                                                mode=W8A16, max_seq=16)
    assert rep.leaked_blocks == 0
    # the chunk check on a cache of its own: slot 1 primed, every slot
    # on blocks of its own (a retired slot's table points at the trash
    # block, where one pass and the per-token steps alias)
    if paged:
        cache = R.init_paged_cache(cfg, 4, 16, 4, 17, device=cuda)
        cache["block_tables"].copy_(torch.arange(
            1, 17, dtype=torch.int32, device=cuda).reshape(4, 4))
    else:
        cache = R.init_cache(cfg, 4, 16, device=cuda)
    src = torch.from_numpy(reqs[1].source).to(cuda, torch.bfloat16)
    src = torch.nn.functional.pad(src, (0, 0, 0, cfg.n_patches
                                        - src.shape[0]))[None]
    ST.make_prime_step(cfg, mode=W8A16)(params, src, cache, 1,
                                        reqs[1].source.shape[0])
    chunk = ST.jit_prefill_chunk_step(
        ST.make_prefill_chunk_step(cfg, mode=W8A16, chunk=4))
    per_token = ST.make_per_token_chunk_step(cfg, mode=W8A16, chunk=4)
    a, b = _clone(cache), _clone(cache)
    chunk(params, [5, 6, 7, 8], a, 1, 2, 4)
    per_token(params, [5, 6, 7, 8], b, 1, 2, 4)
    for k in cache:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# training: the attention's gradient and the train step on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 16])
def test_flash_gradient_on_card_matches_plain(cuda, window):
    """ops.flash_attention on the card (the kernel's forward, the
    Function's backward flash_attention_bwd) against autograd of the plain
    version, bf16: the forward and dQ, dK, dV within one bf16 ulp; the
    backward runs no plain forward."""
    g = torch.Generator(device=cuda).manual_seed(36)
    q4, k4, v4, do4 = (torch.randn((2, 64, 4, 128), generator=g,
                                   device=cuda).to(torch.bfloat16)
                       for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q4, k4, v4)]
    launches = FA.flash_attention_bhsd.launches
    out = ops.flash_attention(*leaves, causal=True, window=window)
    calls = FA.flash_attention_ref.calls
    got = torch.autograd.grad(out, leaves, do4)
    assert FA.flash_attention_bhsd.launches == launches + 1
    assert FA.flash_attention_ref.calls == calls
    bhsd = [t.transpose(1, 2).reshape(8, 64, 128) for t in (q4, k4, v4, do4)]
    plain = [t.clone().requires_grad_(True) for t in bhsd[:3]]
    ref = FA.flash_attention_ref(*plain, causal=True, window=window)
    want = torch.autograd.grad(ref, plain, bhsd[3])
    pairs = [(out.transpose(1, 2).reshape(8, 64, 128), ref)]
    pairs += [(a.transpose(1, 2).reshape(8, 64, 128), b)
              for a, b in zip(got, want)]
    for a, b in pairs:
        a, b = a.float(), b.float()
        tol = 2.0 ** -7 * b.abs() + 1e-5 * b.pow(2).mean().sqrt()
        assert ((a - b).abs() <= tol).all()


def test_train_step_on_card(cuda):
    """Reduced starcoder2-3b, three AdamW train steps on the card: finite,
    falling losses, 2 flash launches a layer a step (remat), one backward
    call a layer a step, no plain forward; the loss within 1e-3 and every
    grad leaf within 3% of the port's on the CPU (the tolerances of
    tests/test_torch_train.py against the JAX package)."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = get_config("starcoder2-3b").reduced()
    cpu = R.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    tokens, labels = SyntheticLMData(cfg.vocab, 32, 4).batch_at(0)
    grads = {}
    for dev, params in (("cpu", cpu), (cuda, card)):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        loss = ST.make_loss_fn(cfg)(params, batch)
        grads[str(dev)] = (float(loss.detach()), [
            x.float().cpu() for x in torch.autograd.grad(loss, leaves)])
    (lc, gc), (lg, gg) = grads["cpu"], grads[str(cuda)]
    assert abs(lc - lg) <= 1e-3
    for a, b in zip(gg, gc):
        assert float((a - b).norm() / b.norm()) <= 0.03
    opt = make_optimizer("adamw", lr=3e-3)
    state = opt.init(card)
    step = ST.make_train_step(cfg, opt)
    launches = FA.flash_attention_bhsd.launches
    bwd, calls = FA.flash_attention_bwd.calls, FA.flash_attention_ref.calls
    losses = []
    for t in range(3):
        tokens, labels = SyntheticLMData(cfg.vocab, 32, 8).batch_at(t)
        batch = {"tokens": torch.from_numpy(tokens).to(cuda),
                 "labels": torch.from_numpy(labels).to(cuda)}
        card, state, m = step(card, state, batch, None)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert FA.flash_attention_bhsd.launches - launches == 6 * cfg.n_layers
    assert FA.flash_attention_bwd.calls - bwd == 3 * cfg.n_layers
    assert FA.flash_attention_ref.calls == calls
