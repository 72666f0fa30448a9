"""The sample the check compares: rows copied into a buffer made before the
window, a reservoir, the same for a seed, uniform over the requests
answered however many they are."""
import numpy as np
import torch

from harness.serve import Keeper
from harness.traffic import Schedule


def _closed(seed, sample=16):
    return Schedule(np.zeros((4, 2), np.int32), 4, seed, sample)


def _fill(keeper, n, vocab=8):
    for rid in range(n):
        logits = torch.full((1, vocab), float(rid))
        keeper.offer(rid, logits, 0)


def test_reservoir_repeats_for_a_seed_and_keeps_each_row():
    a, b, c = Keeper(_closed(7), 8, "cpu"), Keeper(_closed(7), 8, "cpu"), Keeper(_closed(8), 8, "cpu")
    for k in (a, b, c):
        _fill(k, 500)
    assert a.sample() == b.sample() != c.sample()
    assert len(a.sample()) == 16 and all(0 <= r < 500 for r in a.sample())
    assert all(float(a.row(r)[0]) == r for r in a.sample())


def test_reservoir_is_uniform_over_the_answered():
    hits = np.zeros(100)
    for seed in range(400):
        k = Keeper(_closed(seed, sample=10), 2, "cpu")
        _fill(k, 100, vocab=2)
        hits[k.sample()] += 1
    # each of 100 requests is kept with probability 0.1: 40 times in 400 draws
    assert hits.min() > 15 and hits.max() < 70
    assert abs(hits[:50].sum() - hits[50:].sum()) < 0.15 * hits.sum()


def test_offers_stop_at_the_close():
    k = Keeper(_closed(1, sample=4), 2, "cpu")
    _fill(k, 3, vocab=2)
    k.offering = False
    k.offer(99, torch.ones((1, 2)), 0)
    assert k.sample() == [0, 1, 2] and k.row(99) is None
