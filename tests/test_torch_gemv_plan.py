"""The W8A16 GEMV's split plan (``kernels/qmatmul.py::gemv_split_plan``),
on the CPU.

The GEMV cuts K into ranges, one per block of a column strip, and adds
their partial sums in range order in the same launch.  The plan is
computed by the wrapper and passed to the kernel; what the kernel relies
on is checked here, for every (K, N) of the four full-width dense
configs and one ragged shape: the plan depends on (K, N) alone, never on
M (a row's bits must not depend on the batch); its ranges are G-aligned,
in order, and cover [0, K) exactly once; and an 8-row decode tick puts
at least one block on each of the card's 132 SMs, or all of N's strips
where those alone are more.
"""
import pytest

from repro_torch.configs import get_config
from repro_torch.kernels import qmatmul as K

SMS = 132


def _projections(arch):
    """(name, K, N) of each W8A16 matmul of a full-width dense config
    (w_gate has w_up's shape, and the untied head the tied one's)."""
    c = get_config(arch)
    d, qd, kvd = c.d_model, c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return [("wq", d, qd), ("wk|wv", d, kvd), ("wo", qd, d),
            ("w_up", d, c.d_ff), ("w_down", c.d_ff, d),
            ("lm_head", d, c.vocab)]


# starcoder2-3b, one ragged shape, then the other dense configs: K =
# 27,392, 16,384, 14,336 (w_down), 6,144, 5,120 and 4,096 (mistral-nemo's
# wo), N up to 152,064 (qwen1.5-32b's head)
DENSE = ("internlm2-20b", "mistral-nemo-12b", "qwen1.5-32b")
SHAPES = _projections("starcoder2-3b") + [("ragged", 3088, 260)] + [
    (f"{arch}:{name}", k, n) for arch in DENSE
    for name, k, n in _projections(arch)]


@pytest.mark.parametrize("name,k,n", SHAPES, ids=[s[0] for s in SHAPES])
def test_split_plan(name, k, n):
    plan = K.gemv_split_plan(k, n)
    # a function of (K, N) only: every M gets the same plan; the scratch
    # (one partial tile per split, one counter per row slab and strip)
    # grows with M
    for m in (1, 2, 8, 9, 16, 64, 512, 513):
        got, work, counters = K.gemv_launch(m, k, n)
        assert got == plan
        if plan.splits > 1:
            assert work == plan.splits * m * n
            assert counters == -(-m // K.GEMV_MT) * plan.strips
        else:
            assert work == counters == 0
    # G-aligned ranges, in order, covering [0, K) exactly once
    ranges = plan.ranges
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    for b, e in ranges:
        assert b < e and b % K.GEMV_G == 0 and e % K.GEMV_G == 0
    # an 8-row tick fills the card, or takes one block per strip
    assert plan.strips == -(-n // K.GEMV_BN)
    blocks = plan.strips * plan.splits      # one row slab at M = 8
    if plan.strips < SMS:
        assert blocks >= SMS
    if name.endswith("lm_head"):   # its strips alone fill the card 5.8+ times
        assert plan.splits == 1


@pytest.mark.parametrize("k,n", [(3076, 256), (3072, 258), (12, 64),
                                 (0, 64), (64, 0)])
def test_split_plan_refuses_shapes_the_kernel_cannot_take(k, n):
    with pytest.raises(ValueError):
        K.gemv_split_plan(k, n)
