"""The port's synthetic data stream (``repro_torch/data``) against the JAX
package's on the CPU: every batch bitwise the reference's, for several
steps, seeds and host splits; and the properties ``tests/test_data.py``
asserts of the reference's (determinism, resumability, host sharding,
shifted labels, the vocabulary, learnable motifs)."""
from collections import Counter

import numpy as np
import pytest

from repro.data import SyntheticLMData as JSyntheticLMData
from repro_torch.data import DataState, SyntheticLMData, make_pipeline


@pytest.mark.parametrize("host_count", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_bitwise_the_reference(seed, host_count):
    """``batch_at`` for steps 0-5 and 1,000, each host's slice: tokens and
    labels equal the reference's, element for element and in dtype."""
    kw = dict(vocab=512, seq_len=64, global_batch=8, seed=seed)
    ours, ref = SyntheticLMData(**kw), JSyntheticLMData(**kw)
    for step in (0, 1, 2, 3, 4, 5, 1000):
        for host in range(host_count):
            got = ours.batch_at(step, host_index=host, host_count=host_count)
            want = ref.batch_at(step, host_index=host, host_count=host_count)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)


def test_iterate_and_make_pipeline():
    """``iterate`` walks ``batch_at`` from a DataState; ``make_pipeline``
    takes the vocabulary from the config and the shape from the spec."""
    class Cfg:
        vocab = 300

    class Shape:
        seq_len, global_batch = 16, 4

    d = make_pipeline(Cfg, Shape, seed=3)
    assert (d.vocab, d.seq_len, d.global_batch, d.seed) == (300, 16, 4, 3)
    it = d.iterate(DataState(3, 5))
    for step in (5, 6, 7):
        (tokens, labels), state = next(it)
        assert state == DataState(3, step)
        np.testing.assert_array_equal(tokens, d.batch_at(step)[0])


def _deterministic_across_instances():
    a = SyntheticLMData(vocab=512, seq_len=32, global_batch=8, seed=7)
    b = SyntheticLMData(vocab=512, seq_len=32, global_batch=8, seed=7)
    for x, y in zip(a.batch_at(13), b.batch_at(13)):
        np.testing.assert_array_equal(x, y)


def _resume_reproduces_stream():
    """batch_at(t) is a pure function of (seed, t): restart-safe."""
    d = SyntheticLMData(vocab=512, seq_len=32, global_batch=8, seed=1)
    run1 = [d.batch_at(t)[0] for t in range(6)]
    run2 = [d.batch_at(t)[0] for t in range(3, 6)]   # "resume at step 3"
    for a, b in zip(run1[3:], run2):
        np.testing.assert_array_equal(a, b)


def _different_steps_differ():
    d = SyntheticLMData(vocab=512, seq_len=32, global_batch=8)
    assert not np.array_equal(d.batch_at(0)[0], d.batch_at(1)[0])


def _labels_are_shifted_tokens():
    d = SyntheticLMData(vocab=512, seq_len=32, global_batch=4)
    tokens, labels = d.batch_at(0)
    np.testing.assert_array_equal(tokens[:, 1:], labels[:, :-1])


def _host_slices_partition_global_batch():
    d = SyntheticLMData(vocab=512, seq_len=16, global_batch=16)
    full, _ = d.batch_at(5)
    for host_count in (1, 2, 4, 8):
        parts = [d.batch_at(5, host_index=i, host_count=host_count)[0]
                 for i in range(host_count)]
        np.testing.assert_array_equal(np.concatenate(parts, axis=0), full)


def _tokens_within_vocab():
    d = SyntheticLMData(vocab=100, seq_len=64, global_batch=4)
    tokens, labels = d.batch_at(2)
    assert tokens.min() >= 0 and tokens.max() < 100
    assert labels.min() >= 0 and labels.max() < 100


def _motifs_give_learnable_structure():
    """Repeated motifs: some 8-gram recurs across the batch."""
    d = SyntheticLMData(vocab=512, seq_len=256, global_batch=8, seed=0)
    tokens, _ = d.batch_at(0)
    grams = Counter()
    for row in tokens:
        for i in range(0, len(row) - 8, 4):
            grams[tuple(row[i:i + 8])] += 1
    assert max(grams.values()) >= 2


PROPERTIES = {
    "deterministic_across_instances": _deterministic_across_instances,
    "resume_reproduces_stream": _resume_reproduces_stream,
    "different_steps_differ": _different_steps_differ,
    "labels_are_shifted_tokens": _labels_are_shifted_tokens,
    "host_slices_partition_global_batch":
        _host_slices_partition_global_batch,
    "tokens_within_vocab": _tokens_within_vocab,
    "motifs_give_learnable_structure": _motifs_give_learnable_structure,
}


@pytest.mark.parametrize("case", list(PROPERTIES))
def test_data_properties(case):
    """The reference's tests/test_data.py, on the port."""
    PROPERTIES[case]()
