"""Metrics: PerfMetrics accumulation (twin of `flexflow_tpu/metrics.py`).

The counters are 0-dim f32 tensors on the model's device, updated by each
step without a host sync; the host reads them only when the user asks
(`FFModel.get_perf_metrics`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .fftype import LossType, MetricsType

_COUNTERS = ("train_all", "train_correct", "cce_loss", "sparse_cce_loss",
             "mse_loss", "rmse_loss", "mae_loss")


@dataclass
class Metrics:
    loss_type: LossType
    measure_accuracy: bool = False
    measure_categorical_crossentropy: bool = False
    measure_sparse_categorical_crossentropy: bool = False
    measure_mean_squared_error: bool = False
    measure_root_mean_squared_error: bool = False
    measure_mean_absolute_error: bool = False

    @staticmethod
    def from_list(loss_type: LossType, metrics: list) -> "Metrics":
        m = Metrics(loss_type)
        flags = {
            MetricsType.METRICS_ACCURACY: "measure_accuracy",
            MetricsType.METRICS_CATEGORICAL_CROSSENTROPY:
                "measure_categorical_crossentropy",
            MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY:
                "measure_sparse_categorical_crossentropy",
            MetricsType.METRICS_MEAN_SQUARED_ERROR:
                "measure_mean_squared_error",
            MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR:
                "measure_root_mean_squared_error",
            MetricsType.METRICS_MEAN_ABSOLUTE_ERROR:
                "measure_mean_absolute_error",
        }
        for mt in metrics:
            setattr(m, flags[MetricsType(mt)], True)
        return m

    def zero_counters(self, device) -> dict:
        return {k: torch.zeros((), dtype=torch.float32, device=device)
                for k in _COUNTERS}

    @torch.no_grad()
    def compute(self, counters, logits, labels, *, from_logits=False,
                scce_sum=None):
        """One batch's contribution. Classification metrics treat every
        leading position as a sample; `from_logits` says the final op is
        not a softmax; `scce_sum`, when given, is the loss pass's CE sum."""
        classification = (
            self.measure_accuracy
            or self.measure_sparse_categorical_crossentropy
            or self.measure_categorical_crossentropy
        )
        if classification:
            n = math.prod(logits.shape[:-1])
            flat = logits.reshape(n, logits.shape[-1])
        else:
            n = logits.shape[0]
        new = dict(counters)
        new["train_all"] = counters["train_all"] + n
        eps = 1e-8
        if (self.measure_accuracy
                or self.measure_sparse_categorical_crossentropy):
            sparse = labels.reshape(-1).long()
        if self.measure_accuracy:
            pred = torch.argmax(flat, dim=-1)
            new["train_correct"] = counters["train_correct"] + torch.sum(
                (pred == sparse).float())
        if self.measure_sparse_categorical_crossentropy:
            if scce_sum is not None:
                contrib = scce_sum.detach()
            else:
                f32 = flat.float()
                logp = (torch.log_softmax(f32, dim=-1) if from_logits
                        else torch.log(f32 + eps))
                contrib = -torch.sum(logp.gather(1, sparse[:, None]))
            new["sparse_cce_loss"] = counters["sparse_cce_loss"] + contrib
        if self.measure_categorical_crossentropy:
            f32 = logits.float()
            logp = (torch.log_softmax(f32, dim=-1) if from_logits
                    else torch.log(f32 + eps))
            new["cce_loss"] = counters["cce_loss"] - torch.sum(labels * logp)
        if (self.measure_mean_squared_error
                or self.measure_root_mean_squared_error
                or self.measure_mean_absolute_error):
            err = logits.float() - labels.float()
        if (self.measure_mean_squared_error
                or self.measure_root_mean_squared_error):
            new["mse_loss"] = counters["mse_loss"] + torch.sum(err ** 2)
        if self.measure_mean_absolute_error:
            new["mae_loss"] = counters["mae_loss"] + torch.sum(torch.abs(err))
        return new


class PerfMetrics:
    """Host-side view of accumulated counters (one device read)."""

    def __init__(self, counters, metrics: Metrics):
        self._c = {k: float(v) for k, v in counters.items()}
        self._m = metrics

    @property
    def train_all(self) -> int:
        return int(self._c["train_all"])

    @property
    def train_correct(self) -> int:
        return int(self._c["train_correct"])

    def get_accuracy(self) -> float:
        return self.train_correct / max(1, self.train_all)

    def get_mean_loss(self) -> float:
        n = max(1, self.train_all)
        if self._m.measure_sparse_categorical_crossentropy:
            return self._c["sparse_cce_loss"] / n
        if self._m.measure_categorical_crossentropy:
            return self._c["cce_loss"] / n
        return self._c["mse_loss"] / n

    def __repr__(self):
        n = max(1, self.train_all)
        parts = [f"train_all={self.train_all}"]
        if self._m.measure_accuracy:
            parts.append(f"accuracy={100.0 * self.get_accuracy():.2f}%")
        if self._m.measure_sparse_categorical_crossentropy:
            parts.append(f"sparse_cce={self._c['sparse_cce_loss'] / n:.4f}")
        if self._m.measure_categorical_crossentropy:
            parts.append(f"cce={self._c['cce_loss'] / n:.4f}")
        if self._m.measure_mean_squared_error:
            parts.append(f"mse={self._c['mse_loss'] / n:.4f}")
        if self._m.measure_mean_absolute_error:
            parts.append(f"mae={self._c['mae_loss'] / n:.4f}")
        return "[" + " ".join(parts) + "]"
