"""Loss functions (twin of `flexflow_tpu/loss.py`).

The loss is a scalar-valued function of the final op's output and the
labels; autograd gives the gradients. The sparse categorical cross-entropy
from logits is a `torch.autograd.Function` with the JAX package's
hand-written backward (`_softmax_xent_sum`, loss.py:25-60): the forward
reduces the (possibly bf16) logits in f32, and the backward emits
(softmax - onehot) * g in the logits' dtype, so no logits-sized f32
gradient exists. Both passes go over the rows in chunks, so their f32
temporaries stay a bounded slice of the logits (the JAX package's XLA
fusion keeps them out of HBM altogether). It is plain PyTorch: the JAX
function is XLA, not Pallas.
"""

from __future__ import annotations

import torch

from .fftype import LossType

_EPS = 1e-8
# f32 elements of one chunk's temporaries in the fused CE
_CE_CHUNK_ELEMS = 1 << 24


def _row_chunks(n_rows: int, n_cols: int):
    step = max(1, _CE_CHUNK_ELEMS // max(1, n_cols))
    for r0 in range(0, n_rows, step):
        yield r0, min(n_rows, r0 + step)


class _SoftmaxXentSum(torch.autograd.Function):
    """Sum over rows of (logsumexp(row) - row[label]), f32."""

    @staticmethod
    def forward(ctx, logits2d, labels1d):
        n, v = logits2d.shape
        lse = torch.empty(n, dtype=torch.float32, device=logits2d.device)
        for r0, r1 in _row_chunks(n, v):
            lse[r0:r1] = torch.logsumexp(logits2d[r0:r1].float(), dim=-1)
        ll = logits2d.gather(1, labels1d[:, None])[:, 0].float()
        ctx.save_for_backward(logits2d, labels1d, lse)
        return torch.sum(lse - ll)

    @staticmethod
    def backward(ctx, g):
        logits2d, labels1d, lse = ctx.saved_tensors
        n, v = logits2d.shape
        out = torch.empty_like(logits2d)
        for r0, r1 in _row_chunks(n, v):
            p = torch.exp(logits2d[r0:r1].float() - lse[r0:r1, None])
            rows = torch.arange(r1 - r0, device=p.device)
            p[rows, labels1d[r0:r1]] -= 1.0  # p - onehot
            out[r0:r1] = (p * g).to(logits2d.dtype)
        return out, None


def softmax_xent_sum(logits2d: torch.Tensor,
                     labels1d: torch.Tensor) -> torch.Tensor:
    return _SoftmaxXentSum.apply(logits2d, labels1d)


def loss_terms(loss_type: LossType, logits, labels,
               last_op_is_softmax: bool, shards: int = 1,
               batch_shards: int | None = None):
    """(scalar loss, reusable sparse-CE sum or None): the CE sum (f32,
    before averaging) goes to Metrics, so the counter does not reduce the
    logits a second time. `logits` may be one of `shards` equal blocks of
    the rows (a rank of a mesh; the batch cut into `batch_shards` of them,
    the default all, the sequence into the rest): the loss is then this
    block's share of the whole batch's, and the shares sum to it (the
    sparse CE is a mean over every position, the others over the
    batch)."""
    lt = LossType(loss_type)
    batch_shards = shards if batch_shards is None else batch_shards
    b = logits.shape[0] * batch_shards
    if lt == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        # every leading position is a sample (LM: (b, s, vocab) logits with
        # (b, s, 1) labels)
        num_classes = logits.shape[-1]
        flat = logits.reshape(-1, num_classes)
        lab = labels.reshape(-1).long()
        if last_op_is_softmax:
            logp2 = torch.log(flat.float() + _EPS)
            ce_sum = -torch.sum(logp2.gather(1, lab[:, None]))
        else:
            ce_sum = softmax_xent_sum(flat, lab)
        return ce_sum / (flat.shape[0] * shards), ce_sum
    return _loss_value_rest(lt, logits, labels, last_op_is_softmax, b,
                            batch_shards), None


def loss_value(loss_type: LossType, logits, labels,
               last_op_is_softmax: bool):
    """Scalar loss. `logits` is the final op's output: probabilities when
    the graph ends in softmax."""
    return loss_terms(loss_type, logits, labels, last_op_is_softmax)[0]


def _loss_value_rest(lt, logits, labels, last_op_is_softmax, b, shards=1):
    logits = logits.float()
    if lt == LossType.LOSS_CATEGORICAL_CROSSENTROPY:
        logp = (torch.log(logits + _EPS) if last_op_is_softmax
                else torch.log_softmax(logits, -1))
        return -torch.sum(labels * logp) / b
    if lt == LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE:
        sq = (logits - labels) ** 2
        if sq.dim() > 1:  # torch reads dim=() as every dim
            sq = torch.sum(sq, dim=tuple(range(1, sq.dim())))
        return torch.mean(sq) / shards
    if lt == LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE:
        return torch.sum((logits - labels) ** 2) / b
    if lt == LossType.LOSS_IDENTITY:
        return torch.sum(logits) / b
    raise ValueError(f"unknown loss {lt}")
