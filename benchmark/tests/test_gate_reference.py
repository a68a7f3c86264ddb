"""The plain reference held to the port at a tiny size on the CPU, through
the harness's own run of a cell: sound runs come out correct, the control
(the reference in fp8 products) and every fault the cells can have come
out not correct."""

import time

import pytest

SEED = 2 ** 33 + 21


def _seconds(cell) -> float:
    """A window that finishes some tens of tiny requests even on a busy
    CPU (a serving step there can take tens of milliseconds)."""
    return 0.2 if cell.traffic["kind"] == "train" else 1.5


def _run(cell, variants=()):
    import run

    return cell.kind().run(cell, SEED, _seconds(cell), False,
                           time.perf_counter(), device="cpu",
                           variants=variants)


def _line(cell):
    import run

    return run.run_cell(cell, SEED, _seconds(cell), False,
                        time.perf_counter(), device="cpu")


@pytest.mark.parametrize("name", ["tiny.train", "tiny.serve"])
def test_reference_agrees_with_the_port(tiny_cell, name):
    line = _line(tiny_cell(name))
    assert line["correct"], line["checks"]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-2] == "checks"


def test_training_control_and_half_batch_fail(tiny_cell):
    cell = tiny_cell("tiny.train")
    nums = _run(cell, ("control", "half_batch"))["numbers"]
    import harness

    for variant in ("control", "half_batch"):
        assert not harness.is_correct(nums[variant], cell.limits), nums
        worst = max(nums[variant][k] / nums[k] for k in cell.limits)
        assert worst >= 3.0


def test_serving_control_fails(tiny_cell):
    cell = tiny_cell("tiny.serve")
    nums = _run(cell, ("control",))["numbers"]
    import harness

    assert not harness.is_correct(nums["control"], cell.limits), nums


def test_a_step_that_returns_its_state_unchanged(tiny_cell, monkeypatch):
    from flexflow_tpu_torch.optimizer import AdamOptimizer

    monkeypatch.setattr(AdamOptimizer, "update",
                        lambda self, grads, params, slots, step:
                        (params, slots))
    line = _line(tiny_cell("tiny.train"))
    assert not line["correct"]
    assert line["checks"]["update_gap"]["value"] >= 0.99


def test_half_the_batch_left_out(tiny_cell, monkeypatch):
    import flexflow_tpu_torch.executor as ex

    real = ex.loss_terms

    def half(loss_type, logits, labels, *a, **k):
        n = logits.shape[0] // 2
        return real(loss_type, logits[:n], labels[:n], *a, **k)

    monkeypatch.setattr(ex, "loss_terms", half)
    line = _line(tiny_cell("tiny.train"))
    assert not line["correct"], line["checks"]


def test_a_token_altered_where_it_is_produced(tiny_cell, monkeypatch):
    from flexflow_tpu_torch.serving import scheduler

    real = scheduler.ContinuousBatchingScheduler.note_token

    def altered(self, slot, token):
        return real(self, slot, (int(token) + 1) % 64)

    monkeypatch.setattr(scheduler.ContinuousBatchingScheduler, "note_token",
                        altered)
    line = _line(tiny_cell("tiny.serve"))
    assert not line["correct"], line["checks"]
