"""Training cells: the GPT model built by the program's
`build_transformer_lm`, compiled with its AdamOptimizer and sparse
cross-entropy, trained through `FFModel.fit`, the path users run.

Set-up builds one model, writes the seed's weights into its master
tensors on the device, and drives it through `check.steps` steps by the
window's own call (`fit` over one batch each, on rows that all differ),
reading each step's loss from the program's metric counter, the first
gradient from Adam's state after one step and each leaf's change after
the last. The window then calls `fit` over epochs of `steps_per_fit`
batches until its seconds are spent. Once it has closed and the peak has
been read, the program is freed and the plain reference follows the same
steps from the same weights and rows.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np

import harness
import program
from reference import gpt as ref


def _data(traffic: dict, vocab: int, seed: int, n_rows: int):
    """(tokens, positions, labels) of `n_rows` rows, uniform tokens from the
    seed, labels the next token."""
    s = int(traffic["sequence"])
    rng = np.random.default_rng([int(seed), 0x7EA1])
    toks = rng.integers(0, vocab, (n_rows, s + 1), dtype=np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (n_rows, s)).copy()
    return toks[:, :-1].copy(), pos, toks[:, 1:, None].copy()


def _per_leaf(ff, shape, seed: int, device, fn) -> dict:
    """{(node, weight): fn(program leaf key, start value)} with the seed's
    starting weights made again a group at a time."""
    out = {}
    for g in ref.groups(shape):
        for key, p0 in ref.make_group(shape, seed, g, device).items():
            out[key] = float(fn(key, p0))
    return out


def compare(prog: dict, want: dict) -> dict:
    """The numbers compared: the widest loss gap over the steps, and the
    worst leaf's gap of first-gradient norms and of change norms, each
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone under Adam
    and are left out of the change."""
    loss_gap = max(abs(a - b) for a, b in zip(prog["loss"], want["loss"]))
    g_ref = want["grad_norm"]
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(prog["grad_norm"][k] - g_ref[k]) / max(g_ref[k], g_med)
                   for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    c_ref = want["change_norm"]
    c_med = statistics.median(c_ref[k] for k in moved)
    update_gap = max(abs(prog["change_norm"][k] - c_ref[k])
                     / max(c_ref[k], c_med) for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap}


def program_steps(ff, shape, seed, traffic, batches, device) -> dict:
    """The check's steps through `fit`: losses, first gradients and the
    changes, read from the program's state."""
    import torch

    o = traffic["optimizer"]
    b = int(traffic["batch"])
    losses, grad_norm = [], None
    for i, (x, y) in enumerate(batches):
        ff.reset_metrics()
        ff.fit(x, y, epochs=1, batch_size=b, verbose=False)
        losses.append(ff.get_perf_metrics().get_mean_loss())
        if i == 0:
            m = ff._opt_slots["m"]
            with torch.no_grad():
                grad_norm = _per_leaf(
                    ff, shape, seed, device,
                    lambda k, p0: (m[k[0]][k[1]] / (1.0 - o["beta1"])
                                   - o["weight_decay"] * p0).norm())
    with torch.no_grad():
        change = _per_leaf(ff, shape, seed, device,
                           lambda k, p0: (ff._params[k[0]][k[1]] - p0).norm())
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change}


def reference_steps(shape, seed, traffic, batches, device, matmul=None,
                    half_batch=False, frozen=False) -> dict:
    import torch

    o = traffic["optimizer"]
    tb = [(torch.as_tensor(x["tokens"], device=device),
           torch.as_tensor(y[..., 0], device=device)) for x, y in batches]
    return ref.train_reference(
        shape, seed, tb,
        ref.AdamSpec(alpha=o["alpha"], beta1=o["beta1"], beta2=o["beta2"],
                     epsilon=o["epsilon"], weight_decay=o["weight_decay"]),
        int(traffic["check"]["rows_per_block"]), device,
        matmul=matmul or ref.fp32_matmul, half_batch=half_batch,
        frozen=frozen)


def _batches(traffic, vocab, seed, n_check, steps_per_fit):
    b = int(traffic["batch"])
    tok, pos, lab = _data(traffic, vocab, seed, b * (n_check + steps_per_fit))
    check = [({"tokens": tok[i * b:(i + 1) * b],
               "positions": pos[i * b:(i + 1) * b]}, lab[i * b:(i + 1) * b])
             for i in range(n_check)]
    w0 = n_check * b
    window = ({"tokens": tok[w0:], "positions": pos[w0:]}, lab[w0:])
    return check, window


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", variants=()) -> dict:
    """One run of a training cell: the window's numbers and end-to-end
    values, the profiled steps (with `trace`), the numbers compared and
    the peak; `run.run_cell` makes the result line of them. `variants`
    (readings.py only) adds the control's and planted faults' numbers."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic, config = cell.traffic, cell.config
    shape = ref.GPTShape.of(config)
    b, s = int(traffic["batch"]), int(traffic["sequence"])
    k = int(traffic["steps_per_fit"])
    n_check = int(traffic["check"]["steps"])
    check_batches, (wx, wy) = _batches(traffic, shape.vocab, seed, n_check, k)

    ff = program.build_train_model(config, traffic, seed, device)
    dev = ff.device
    program.write_weights(ff, shape, seed, dev)
    prog = program_steps(ff, shape, seed, traffic, check_batches, dev)

    spans = harness.Spans()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_open = time.perf_counter()
    steps = 0
    while True:
        with spans.span("fit"):
            ff.fit(wx, wy, epochs=1, batch_size=b, verbose=False)
        steps += k
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_close = time.perf_counter()
        if t_close - t_open >= seconds:
            break
    window_s = t_close - t_open
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window = {"steps": steps, "tokens": steps * b * s, "window_s": window_s,
              "setup_s": t_open - t_start,
              "tokens_per_s": steps * b * s / window_s}

    traced = {}
    if trace:
        traced = profile_steps(ff, traffic, wx, wy, spans, torch, dev)
    del ff
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_steps(shape, seed, traffic, check_batches, dev)
    numbers = compare(prog, want)
    # the readings that set the limits (readings.py), never in a timed
    # run: the control, the reference one precision step below the
    # program's, and planted faults, the mean over half the batch and a
    # step that leaves the state unchanged, in the reference's place
    for v in variants:
        other = reference_steps(
            shape, seed, traffic, check_batches, dev,
            matmul=ref.fp8_matmul if v == "control" else None,
            half_batch=v == "half_batch", frozen=v == "frozen")
        numbers[v] = compare(other, want)
    return {"window": window, "traced": traced, "numbers": numbers,
            "end_to_end": {"train_tokens_per_s": window["tokens_per_s"],
                           "setup_s": window["setup_s"]},
            "attempted": steps, "failed": 0, "peak_bytes": peak,
            "readings": readings(prog, want, numbers)}


def readings(prog: dict, want: dict, numbers: dict) -> dict:
    """What the run's standard error shows of the comparison: each step's
    loss on both sides and the leaf behind each worst gap."""
    g_med = statistics.median(want["grad_norm"].values())
    moved = [k for k, g in want["grad_norm"].items() if g >= 1e-3 * g_med]

    def worst(part, keys):
        r = want[part]
        med = statistics.median(r[k] for k in keys)
        k = max(keys, key=lambda k: abs(prog[part][k] - r[k]) / max(r[k], med))
        return f"{k[0]}.{k[1]}"

    return {"loss_program": prog["loss"], "loss_reference": want["loss"],
            "worst_grad_leaf": worst("grad_norm", list(want["grad_norm"])),
            "worst_change_leaf": worst("change_norm", moved), **numbers}


def profile_steps(ff, traffic, wx, wy, spans, torch, dev) -> dict:
    """The profiled sub-window: one `fit` over `trace.steps` batches of
    the window's rows."""
    import devtrace as tr

    b, n = int(traffic["batch"]), int(traffic["trace"]["steps"])
    x = {kk: v[:b * n] for kk, v in wx.items()}
    with tr.profiled(spans, torch) as got:
        with spans.span(tr.REGION):
            with spans.span("fit"):
                ff.fit(x, wy[:b * n], epochs=1, batch_size=b, verbose=False)
            torch.cuda.synchronize(dev)
    return {"steps": n, "step_trace": got[0]}
