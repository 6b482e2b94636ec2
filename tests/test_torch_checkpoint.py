"""The port's checkpoints (``repro_torch/checkpoint``) on the CPU: the
cases of ``tests/test_checkpoint.py`` (round trip, metadata, the commit
protocol, the manager's async save, retention and empty restore) on a
port tree that holds an ``AdamWState``; and what the port adds: bf16
leaves (no numpy dtype), None subtrees, restore onto ``like``'s dtype,
and a snapshot that later in-place writes do not reach."""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    read_metadata, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.optim import adafactor_init, adamw_init
from repro_torch.optim.optimizers import tree_leaves


def _tree(seed=0, keep_master=False):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn((8, 16), generator=g),
              "b": torch.zeros((16,)),
              "layers": [{"s": torch.randn((4,), generator=g)}
                         for _ in range(2)]}
    opt = adamw_init(params, keep_master=keep_master)
    opt.step.fill_(3)
    for m in tree_leaves(opt.m):
        m.fill_(1.0)
    return {"params": params, "opt": opt}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _save_restore_identical(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 10, t)
    out = restore_checkpoint(str(tmp_path), 10, t)
    _equal(t, out)
    assert type(out["opt"]) is type(t["opt"]) and out["opt"].master is None


def _metadata(tmp_path):
    save_checkpoint(str(tmp_path), 5, _tree(), {"data_step": 5})
    assert read_metadata(str(tmp_path), 5)["data_step"] == 5


def _uncommitted_ignored(tmp_path):
    """A save that died before the marker must be invisible."""
    path = save_checkpoint(str(tmp_path), 7, _tree())
    os.remove(os.path.join(path, "COMMITTED"))
    assert latest_step(str(tmp_path)) is None


def _tmp_dirs_ignored(tmp_path):
    os.makedirs(tmp_path / "step_0000000009.tmp")
    save_checkpoint(str(tmp_path), 4, _tree())
    assert latest_step(str(tmp_path)) == 4


def _digest_mismatch_raises(tmp_path):
    t = _tree()
    path = save_checkpoint(str(tmp_path), 3, t)
    victim = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[0]
    arr = np.load(os.path.join(path, victim))
    np.save(os.path.join(path, victim), arr + 1)
    with pytest.raises(IOError, match="digest"):
        restore_checkpoint(str(tmp_path), 3, t)


def _latest_picks_newest_committed(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    save_checkpoint(str(tmp_path), 2, _tree())
    p3 = save_checkpoint(str(tmp_path), 3, _tree())
    os.remove(os.path.join(p3, "COMMITTED"))   # partial newest
    assert latest_step(str(tmp_path)) == 2


def _async_save_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save_async(1, t)
    mgr.wait()
    step, out = mgr.restore_latest(t)
    assert step == 1
    _equal(t, out)


def _retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
        mgr.wait()
    steps = sorted(int(d[5:]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]


def _restore_none_when_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest(_tree()) == (None, None)


CASES = {
    "save_restore_identical": _save_restore_identical,
    "metadata": _metadata,
    "uncommitted_ignored": _uncommitted_ignored,
    "tmp_dirs_ignored": _tmp_dirs_ignored,
    "digest_mismatch_raises": _digest_mismatch_raises,
    "latest_picks_newest_committed": _latest_picks_newest_committed,
    "async_save_and_restore": _async_save_and_restore,
    "retention": _retention,
    "restore_none_when_empty": _restore_none_when_empty,
}


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_cases(case, tmp_path):
    """The reference's TestRoundTrip, TestCommitProtocol and TestManager
    on a port tree (params and an AdamWState)."""
    CASES[case](tmp_path)


def test_bf16_leaves_master_and_adafactor_round_trip(tmp_path):
    """bf16 params (stored as their int16 bits) and an f32 master, and an
    Adafactor state, come back bitwise in their dtypes."""
    params = {"w": torch.randn((16, 8)).to(torch.bfloat16),
              "b": torch.randn((8,)).to(torch.bfloat16)}
    tree = {"params": params, "opt": adamw_init(params, keep_master=True),
            "ada": adafactor_init(params)}
    tree["ada"].vr["w"].uniform_()
    save_checkpoint(str(tmp_path), 2, tree)
    out = restore_checkpoint(str(tmp_path), 2, tree)
    _equal(tree, out)
    assert out["params"]["w"].dtype == torch.bfloat16
    assert out["opt"].master["w"].dtype == torch.float32


def test_restore_takes_like_dtype_and_device(tmp_path):
    """Each leaf is restored onto the device and dtype of ``like``'s."""
    save_checkpoint(str(tmp_path), 1, {"w": torch.arange(6.0)})
    out = restore_checkpoint(str(tmp_path), 1,
                             {"w": torch.zeros(6, dtype=torch.float64)})
    assert out["w"].dtype == torch.float64 and out["w"].device.type == "cpu"
    assert out["w"].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


def test_async_snapshot_is_taken_at_the_call(tmp_path):
    """``save_async`` copies the tree on the caller's thread: writing the
    params in place right after (the next train step) does not reach the
    checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    want = [x.clone() for x in tree_leaves(t)]
    mgr.save_async(1, t)
    for x in tree_leaves(t):
        x.add_(1)
    mgr.wait()
    _, out = mgr.restore_latest(t)
    for x, y in zip(tree_leaves(out), want):
        assert torch.equal(x, y)


def test_async_error_surfaces_on_wait(tmp_path):
    """An error of the background write is raised by the next wait()."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker))
    mgr.save_async(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                              # raised once
