"""The decode attention kernels' split of a row's slots, on the CPU.

The CUDA kernels (``csrc/decode_attention_int8.cuh``) cut each row's valid
slots into at most ``DECODE_NSPLIT`` chunks, one block each, and the last
block of a (row, kv head) to arrive combines the chunks' (m, l, acc) in
chunk order.  The kernels run only on the card; here the chunk bounds
(``kernels/decode_attention.py::decode_chunk_bounds``, the formula the
kernels compute on the device) are checked, and a torch emulation of the
split and the ordered combine is held to the dense plain version and to
the JAX oracle (``repro/kernels/ref.py::decode_attention_int8_ref``) on
the same numpy inputs.  The kernels themselves are held to the plain
version, and their rows bitwise across batch, capacity and chunk
boundaries, by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as A
from repro_torch.kernels import scratch

CUH = (Path(A.__file__).parent / "csrc" / "decode_attention_int8.cuh")
VALID_LENS = [0, 1, 15, 16, 17, 47, 48, 63, 64, 65, 255, 256, 257, 517,
              1000, 1023, 1024, 1025, 2048, 3000, 4095, 4096, 10000]


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops; one intra-op thread keeps them fast beside the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("vl", VALID_LENS)
def test_chunk_bounds_tile_the_row_in_order(vl):
    bounds = A.decode_chunk_bounds(vl)
    assert 1 <= len(bounds) <= A.DECODE_NSPLIT
    assert bounds[0][0] == 0 and bounds[-1][1] == vl
    for (s0, e0), (s1, _) in zip(bounds, bounds[1:]):
        assert e0 == s1
    if not vl:
        assert bounds == [(0, 0)]
        return
    # roundup(ceil(vl / NSPLIT), CHUNK_ALIGN) slots, the last chunk shorter
    per = -(-vl // A.DECODE_NSPLIT)
    length = -(-per // A.DECODE_CHUNK_ALIGN) * A.DECODE_CHUNK_ALIGN
    for s, e in bounds[:-1]:
        assert e - s == length
    assert 0 < bounds[-1][1] - bounds[-1][0] <= length


@pytest.mark.parametrize("vl,chunks,length", [
    (48, 1, 64), (17, 1, 64), (64, 1, 64), (65, 2, 64), (256, 4, 64),
    (257, 5, 64), (1024, 16, 64), (1025, 9, 128), (4096, 16, 256),
    (3000, 16, 192), (2048, 16, 128), (517, 9, 64), (129, 3, 64)])
def test_chunk_bounds_of_the_serving_shapes(vl, chunks, length):
    """The smoke's short rows (one chunk: no combine), the long-context
    case's ragged rows and the edges of the chunks."""
    bounds = A.decode_chunk_bounds(vl)
    assert len(bounds) == chunks
    assert bounds[0] == (0, min(vl, length))


def test_chunk_constants_match_the_kernel_source():
    """The Python mirror of the kernels' constants, which the wrappers use
    to size the workspace, equals the source's."""
    src = CUH.read_text()
    for name, value in (("NSPLIT", A.DECODE_NSPLIT),
                        ("CHUNK_ALIGN", A.DECODE_CHUNK_ALIGN),
                        ("MAXG", A.MAX_G), ("MAXHD", A.MAX_HD)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name


def _split_attention(q, k, v, ks, vs, vl, k_new=None, v_new=None):
    """The kernels' algorithm in torch, f32: each row's chunks
    (``decode_chunk_bounds``) reduced to (m, l, acc) with the k scale in
    the score and the v scale in p, the chunks combined in chunk order
    (M = max m_i; l and acc summed as exp(m_i - M) x_i), then the append
    column and acc / max(l, 1e-30).  Only slots inside a chunk are read,
    so the capacity never enters."""
    b, kvh, g, hd = q.shape
    sm_scale = hd ** -0.5
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32)
    for r in range(b):
        qr = q[r].float()
        parts = []
        for s0, s1 in A.decode_chunk_bounds(int(vl[r])):
            if s1 == s0:
                parts.append((torch.full((kvh, g), A.NEG_INF),
                              torch.zeros((kvh, g)),
                              torch.zeros((kvh, g, hd))))
                continue
            kf = k[r, s0:s1].float()                           # (n, KV, hd)
            sc = (torch.einsum("kgd,nkd->kgn", qr, kf) * sm_scale
                  * ks[r, s0:s1].reshape(-1, kvh).T[:, None, :])
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            pv = p * vs[r, s0:s1].reshape(-1, kvh).T[:, None, :]
            acc = torch.einsum("kgn,nkd->kgd", pv, v[r, s0:s1].float())
            parts.append((m, p.sum(-1), acc))
        big_m = torch.stack([m for m, _, _ in parts]).amax(0)
        l_sum = torch.zeros((kvh, g))
        acc = torch.zeros((kvh, g, hd))
        for m, l_i, acc_i in parts:
            e = torch.exp(m - big_m)
            l_sum = l_sum + e * l_i
            acc = acc + e[..., None] * acc_i
        if k_new is not None:
            kn = k_new.reshape(b, kvh, hd)[r].float()
            vn = v_new.reshape(b, kvh, hd)[r].float()
            s_new = (qr * kn[:, None, :]).sum(-1) * sm_scale
            m_fin = torch.maximum(big_m, s_new)
            a, pn = torch.exp(big_m - m_fin), torch.exp(s_new - m_fin)
            l_sum = l_sum * a + pn
            acc = acc * a[..., None] + pn[..., None] * vn[:, None, :]
        out[r] = acc / l_sum.clamp_min(1e-30)[..., None]
    return out


def _inputs(rng, b, s, kvh, g, hd):
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    k = rng.integers(-127, 128, (b, s, kvh, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (b, s, kvh, hd)).astype(np.int8)
    ks = (rng.random((b, s, kvh, 1)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((b, s, kvh, 1)) * 0.02 + 1e-3).astype(np.float32)
    return q, k, v, ks, vs


@pytest.mark.parametrize("append", [False, True])
@pytest.mark.parametrize("g", [1, 12])
def test_split_emulation_matches_plain_and_jax_oracle(g, append):
    """Rows at the chunk edges the formula makes below 300 slots, and 0:
    the split and ordered combine against the dense softmax of
    the plain version and of the JAX oracle.  The same f32 terms, summed
    in another order and with one exp per chunk maximum: 1e-4 relative
    + 1e-5 absolute, the kernels' tolerance against the plain version."""
    rng = np.random.default_rng(10 * g + append)
    b, s, kvh, hd = 8, 300, 2, 32
    q, k, v, ks, vs = _inputs(rng, b, s, kvh, g, hd)
    vl = np.array([0, 1, 17, 63, 64, 65, 256, 257], np.int32)
    kn = vn = None
    if append:
        kn = rng.standard_normal((b, kvh, hd)).astype(np.float32)
        vn = rng.standard_normal((b, kvh, hd)).astype(np.float32)
    t = torch.from_numpy
    tkn = None if kn is None else t(kn)
    tvn = None if vn is None else t(vn)
    got = _split_attention(t(q), t(k), t(v), t(ks), t(vs), t(vl),
                           tkn, tvn)
    plain = A.decode_attention_int8_ref(t(q), t(k), t(v), t(ks), t(vs),
                                        t(vl), k_new=tkn, v_new=tvn)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-5)
    want = np.asarray(jref.decode_attention_int8_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(vl),
        k_new=None if kn is None else jnp.asarray(kn),
        v_new=None if vn is None else jnp.asarray(vn)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    if append:          # an empty cache and the column: exactly v_new
        assert torch.equal(got[0], t(vn)[0][:, None, :].expand(kvh, g, hd))
    else:               # an empty cache alone: zeros
        assert torch.equal(got[0], torch.zeros((kvh, g, hd)))


def test_split_emulation_rows_do_not_depend_on_batch_or_capacity():
    """A row's chunks depend on its valid_len alone, so the emulated row
    is the same bits alone, inside a batch of 8 and in a cache of 48 or of
    300 slots."""
    rng = np.random.default_rng(3)
    q, k, v, ks, vs = _inputs(rng, 8, 300, 2, 12, 32)
    t = torch.from_numpy
    vl = torch.tensor([48, 17, 0, 33, 16, 47, 1, 40], dtype=torch.int32)
    full = _split_attention(t(q), t(k), t(v), t(ks), t(vs), vl)
    for i in range(8):
        for cap in (48, 300):
            cache = [t(x[i:i + 1, :cap]) for x in (k, v, ks, vs)]
            one = _split_attention(t(q[i:i + 1]), *cache, vl[i:i + 1])
            assert torch.equal(one[0], full[i])


def test_scratch_is_kept_per_stream_and_grows():
    """``kernels/scratch.py``: one workspace and one zeroed counter array
    per (device, stream), reused by smaller requests and grown by larger
    ones."""
    cpu = torch.device("cpu")
    key = (cpu.index, -1)
    try:
        w1, c1 = scratch.get(cpu, -1, 100, 4)
        assert scratch.get(cpu, -1, 50, 2) == (w1, c1)
        w2, c2 = scratch.get(cpu, -1, 200, 8)
        work, counters = scratch._SCRATCH[key]
        assert work.numel() == 200 and counters.numel() == 8
        assert (w2, c2) == (work.data_ptr(), counters.data_ptr())
        assert not counters.any() and counters.dtype == torch.int32
        assert scratch.get(cpu, -2, 10, 1) != (w2, c2)
    finally:
        scratch._SCRATCH.pop(key, None)
        scratch._SCRATCH.pop((cpu.index, -2), None)
