"""The traffic generators: the same seed gives the same inputs, every seed
the same set of sizes, and no request passes its limits."""

import numpy as np
import pytest

import harness

SERVE = harness.load_json("traffic", "chat-closed-64")


def _requests(seed, n, traffic=SERVE):
    kind = harness.load_module("kinds", "serve_closed_loop")
    r = kind.Requests(traffic, 50257, seed)
    return [r.next() for _ in range(n)]


def test_serve_requests_repeat_per_seed():
    a, b = _requests(2 ** 33 + 5, 50), _requests(2 ** 33 + 5, 50)
    assert a == b
    assert a != _requests(2 ** 33 + 6, 50)


def test_serve_lengths_keep_their_limits():
    t = SERVE
    for prompt, out in _requests(7, 3 * t["pool"] // 2):
        assert t["prompt"]["min"] <= len(prompt) <= t["prompt"]["max"]
        assert out >= 1 and len(prompt) + out <= t["max_total"]
        assert out <= t["output"]["max"]
        assert all(0 <= x < 50257 for x in prompt[:16])


def test_every_seed_draws_the_same_set_of_sizes():
    n = SERVE["pool"]
    a = sorted(len(p) for p, _ in _requests(1, n))
    b = sorted(len(p) for p, _ in _requests(99, n))
    assert a == b
    med = np.median(a)
    assert abs(med - SERVE["prompt"]["median"]) <= 2


@pytest.mark.parametrize("traffic", ["train-8x2048-adam",
                                     "train-32x1024-adam"])
def test_train_rows_repeat_per_seed_and_all_differ(traffic):
    kind = harness.load_module("kinds", "train")
    t = dict(harness.load_json("traffic", traffic), sequence=64)
    x1, p1, y1 = kind._data(t, 50257, 2 ** 31 + 11, 12)
    x2, _, y2 = kind._data(t, 50257, 2 ** 31 + 11, 12)
    assert (x1 == x2).all() and (y1 == y2).all()
    assert (x1[:, 1:] == y1[:, :-1, 0]).all()
    assert len({r.tobytes() for r in x1}) == 12
    assert (p1 == np.arange(64)).all()
    x3, _, _ = kind._data(t, 50257, 2 ** 31 + 12, 12)
    assert not (x1 == x3).all()
