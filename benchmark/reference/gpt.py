"""The plain reference: a GPT decoder in plain PyTorch, its loss, its
gradients by autograd and the Adam update, in float32 with TF32 off.

It imports nothing of the program under test. The layer equations are
the ones the configuration files state (pre-LN blocks, learned absolute
positions, exact GELU MLP of 4d, multi-head causal attention with biases
on the four projections, a final LayerNorm, an untied head with no bias);
each departure from the published models is recorded in the
configuration's file, not here.

Weights are made by `make_weights` from a seed on the device, one draw
per group (the embeddings, each block, the head), so the program and the
reference are given the same numbers and the reference can make them
again after the program's state is gone. Matrices are (in, out): a
projection is `x @ w + b`.

`matmul` is the one place where precision enters: `fp32_matmul` is the
reference; `fp8_matmul` is the control, the step below the program's
bfloat16, with e4m3 operands and e5m2 output gradients, each scaled per
tensor by its largest magnitude, and products summed in float32.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


@dataclass(frozen=True)
class GPTShape:
    """The sizes the reference needs, read from a configuration file."""

    vocab: int
    d: int
    heads: int
    layers: int
    positions: int
    mlp: int

    @staticmethod
    def of(config: dict) -> "GPTShape":
        m = config["model"]
        return GPTShape(vocab=m["vocab_size"], d=m["hidden_size"],
                        heads=m["num_heads"], layers=m["num_layers"],
                        positions=m["sequence_length"],
                        mlp=m["mlp_ratio"] * m["hidden_size"])


def leaf_specs(s: GPTShape) -> list[tuple[str, str, tuple, str]]:
    """(node, weight, shape, init) of every trainable leaf, in draw order.
    init: "normal" (std 0.02), "resid" (0.02 / sqrt(2 layers), the two
    projections into the residual stream), "pos" (0.01), "ones",
    "zeros"."""
    d, f = s.d, s.mlp
    out = [("wte", "kernel", (s.vocab, d), "normal"),
           ("wpe", "kernel", (s.positions, d), "pos")]
    for i in range(s.layers):
        p = f"l{i}_"
        out += [(p + "ln1", "scale", (d,), "ones"),
                (p + "ln1", "bias", (d,), "zeros")]
        for w in ("wq", "wk", "wv"):
            out.append((p + "attn", w, (d, d), "normal"))
        out.append((p + "attn", "wo", (d, d), "resid"))
        for b in ("bq", "bk", "bv", "bo"):
            out.append((p + "attn", b, (d,), "zeros"))
        out += [(p + "ln2", "scale", (d,), "ones"),
                (p + "ln2", "bias", (d,), "zeros"),
                (p + "ffn1", "kernel", (d, f), "normal"),
                (p + "ffn1", "bias", (f,), "zeros"),
                (p + "ffn2", "kernel", (f, d), "resid"),
                (p + "ffn2", "bias", (d,), "zeros")]
    out += [("ln_f", "scale", (d,), "ones"), ("ln_f", "bias", (d,), "zeros"),
            ("lm_head", "kernel", (d, s.vocab), "normal")]
    return out


def group_of(node: str) -> str:
    """The draw group of a node: its block, or the embeddings or head."""
    if node.startswith("l") and "_" in node and node[1].isdigit():
        return node.split("_", 1)[0]
    return "head" if node in ("ln_f", "lm_head") else "embed"


def _group_seed(seed: int, group: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_group(s: GPTShape, seed: int, group: str, device) -> dict:
    """The float32 leaves of one draw group, {(node, weight): tensor}, from
    one `randn` call of a generator on `device` seeded by (seed, group)."""
    specs = [sp for sp in leaf_specs(s) if group_of(sp[0]) == group]
    drawn = [sp for sp in specs if sp[3] in ("normal", "resid", "pos")]
    total = sum(math.prod(sp[2]) for sp in drawn)
    gen = torch.Generator(device=device).manual_seed(_group_seed(seed, group))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    std = {"normal": 0.02, "resid": 0.02 / math.sqrt(2 * s.layers),
           "pos": 0.01}
    out, at = {}, 0
    for node, w, shape, init in specs:
        if init == "ones":
            out[(node, w)] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[(node, w)] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            out[(node, w)] = flat[at:at + n].view(shape).mul_(std[init])
            at += n
    return out


def groups(s: GPTShape) -> list[str]:
    return ["embed"] + [f"l{i}" for i in range(s.layers)] + ["head"]


def make_weights(s: GPTShape, seed: int, device) -> dict:
    """Every leaf, {(node, weight): float32 tensor} on `device`."""
    out = {}
    for g in groups(s):
        out.update(make_group(s, seed, g, device))
    return out


# ------------------------------------------------------------ precision

def fp32_matmul(a, b):
    return torch.matmul(a, b)


def _q(x, dtype):
    """x rounded to an fp8 type, scaled per tensor by its largest
    magnitude, and returned in float32."""
    fmax = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = fmax / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(_q(a, torch.float8_e4m3fn),
                            _q(b, torch.float8_e4m3fn))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gq = _q(g, torch.float8_e5m2)
        aq, bq = _q(a, torch.float8_e4m3fn), _q(b, torch.float8_e4m3fn)
        ga = torch.matmul(gq, bq.transpose(-1, -2))
        if b.dim() == 2:  # a weight: sum over every leading dim of a
            gb = (aq.reshape(-1, aq.shape[-1]).t()
                  @ gq.reshape(-1, gq.shape[-1]))
        else:
            gb = torch.matmul(aq.transpose(-1, -2), gq)
        return ga, gb


def fp8_matmul(a, b):
    return _Fp8Matmul.apply(a, b)


# ------------------------------------------------------------ the model

def forward(W: dict, s: GPTShape, tokens, positions, matmul=fp32_matmul):
    """Logits (b, t, vocab) of token rows (b, t) at positions (b, t)."""
    h = W[("wte", "kernel")][tokens.long()] + W[("wpe", "kernel")][
        positions.long()]
    b, t, d = h.shape
    hd = d // s.heads
    mask = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()

    def ln(x, node):
        return F.layer_norm(x, (d,), W[(node, "scale")], W[(node, "bias")],
                            LN_EPS)

    def heads(x):
        return x.view(b, t, s.heads, hd).transpose(1, 2)

    for i in range(s.layers):
        p = f"l{i}_"
        a = ln(h, p + "ln1")
        q = matmul(a, W[(p + "attn", "wq")]) + W[(p + "attn", "bq")]
        k = matmul(a, W[(p + "attn", "wk")]) + W[(p + "attn", "bk")]
        v = matmul(a, W[(p + "attn", "wv")]) + W[(p + "attn", "bv")]
        q, k, v = heads(q), heads(k), heads(v)
        logits = matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        logits = logits.masked_fill(~mask, float("-inf"))
        o = matmul(torch.softmax(logits, dim=-1), v)
        o = o.transpose(1, 2).reshape(b, t, d)
        h = h + matmul(o, W[(p + "attn", "wo")]) + W[(p + "attn", "bo")]
        m = ln(h, p + "ln2")
        m = F.gelu(matmul(m, W[(p + "ffn1", "kernel")])
                   + W[(p + "ffn1", "bias")], approximate="none")
        h = h + matmul(m, W[(p + "ffn2", "kernel")]) + W[(p + "ffn2", "bias")]
    h = ln(h, "ln_f")
    return matmul(h, W[("lm_head", "kernel")])


def loss_and_grads(W: dict, s: GPTShape, tokens, labels, rows_per_block: int,
                   matmul=fp32_matmul, rows_used=None):
    """The mean cross-entropy over every position of the batch and its
    gradients, {(node, weight): tensor}, computed in blocks of rows so the
    activations of one block at a time are alive. `rows_used` (a count)
    computes the mean over the first rows only: a planted fault."""
    n_rows = tokens.shape[0] if rows_used is None else rows_used
    t = tokens.shape[1]
    positions = torch.arange(t, device=tokens.device)[None, :]
    leaves = {k: v.detach().requires_grad_(True) for k, v in W.items()}
    total = 0.0
    n_tok = n_rows * t
    for r0 in range(0, n_rows, rows_per_block):
        r1 = min(n_rows, r0 + rows_per_block)
        tok = tokens[r0:r1]
        logits = forward(leaves, s, tok, positions.expand(r1 - r0, t),
                         matmul)
        ce = F.cross_entropy(logits.reshape(-1, s.vocab).float(),
                             labels[r0:r1].reshape(-1).long(),
                             reduction="sum")
        (ce / n_tok).backward()
        total += float(ce.detach())
        del logits, ce
    grads = {k: v.grad for k, v in leaves.items()}
    return total / n_tok, grads


@dataclass(frozen=True)
class AdamSpec:
    """The program's Adam: L2 weight decay added to the gradient, the step
    size alpha * sqrt(1 - beta2^t) / (1 - beta1^t), epsilon added to
    sqrt(v)."""

    alpha: float
    beta1: float
    beta2: float
    epsilon: float
    weight_decay: float


@torch.no_grad()
def adam_step(W: dict, grads: dict, m: dict, v: dict, t: int, o: AdamSpec):
    """One update of every leaf, in place; `t` counts from 1."""
    a_t = (o.alpha * math.sqrt(1.0 - o.beta2 ** t) / (1.0 - o.beta1 ** t))
    for k, p in W.items():
        g = grads[k] + o.weight_decay * p
        m[k].mul_(o.beta1).add_(g, alpha=1.0 - o.beta1)
        v[k].mul_(o.beta2).addcmul_(g, g, value=1.0 - o.beta2)
        p.sub_(a_t * m[k] / (v[k].sqrt() + o.epsilon))


def train_reference(s: GPTShape, seed: int, batches, opt: AdamSpec,
                    rows_per_block: int, device, matmul=fp32_matmul,
                    half_batch: bool = False, frozen: bool = False) -> dict:
    """Three (or len(batches)) steps from the seed's weights. Returns the
    loss of each step, each leaf's first raw gradient norm and each
    leaf's change over the steps, as {"loss": [...], "grad_norm": {...},
    "change_norm": {...}}. `batches` are (tokens, labels) on `device`.
    `half_batch` and `frozen` plant a fault: the mean over half the rows,
    or a step that leaves the weights and Adam's state as they were (its
    first gradient then reads as the program would read it from a zero
    first moment: the weight decay term alone)."""
    W = make_weights(s, seed, device)
    m = {k: torch.zeros_like(p) for k, p in W.items()}
    v = {k: torch.zeros_like(p) for k, p in W.items()}
    losses, grad_norm = [], None
    for i, (tok, lab) in enumerate(batches):
        loss, g = loss_and_grads(
            W, s, tok, lab, rows_per_block, matmul,
            rows_used=tok.shape[0] // 2 if half_batch else None)
        losses.append(loss)
        if i == 0:
            grad_norm = {k: float((opt.weight_decay * W[k]).norm()
                                  if frozen else x.norm())
                         for k, x in g.items()}
        if not frozen:
            adam_step(W, g, m, v, i + 1, opt)
        del g
    del m, v
    change = {}
    for grp in groups(s):
        start = make_group(s, seed, grp, device)
        for k, p0 in start.items():
            change[k] = float((W[k] - p0).norm())
        del start
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change}


@torch.no_grad()
def served_gaps(W: dict, s: GPTShape, sequences, matmul=fp32_matmul,
                control_matmul=None) -> dict:
    """For each (prompt, served tokens) pair: run the reference once over
    prompt + served[:-1] and read, at the position that produced each
    served token, how far that token's logit lies below the reference's
    best. With `control_matmul`, also the gap of the token the control
    puts first at the same positions. Returns {"widest": float,
    "tokens": int, "control_widest": float | None}."""
    widest, n, ctl = 0.0, 0, None
    for prompt, served in sequences:
        seq = torch.tensor(list(prompt) + list(served[:-1]),
                           device=W[("wte", "kernel")].device)[None, :]
        pos = torch.arange(seq.shape[1], device=seq.device)[None, :]
        at = slice(len(prompt) - 1, len(prompt) - 1 + len(served))
        ref = forward(W, s, seq, pos, matmul)[0, at].float()
        best = ref.max(dim=-1).values
        got = ref.gather(1, torch.tensor(served, device=ref.device)[:, None])
        widest = max(widest, float((best - got[:, 0]).max()))
        n += len(served)
        if control_matmul is not None:
            low = forward(W, s, seq, pos, control_matmul)[0, at]
            pick = low.float().argmax(dim=-1)
            gap = best - ref.gather(1, pick[:, None])[:, 0]
            ctl = max(ctl or 0.0, float(gap.max()))
    return {"widest": widest, "tokens": n, "control_widest": ctl}
