"""Keras callbacks (reference python/flexflow/keras/callbacks.py:1-90).

Same surface and semantics: `Callback` hook base, `LearningRateScheduler`
(epoch → rate, applied via the optimizer's set_learning_rate),
`VerifyMetrics` (train-end accuracy gate) and `EpochVerifyMetrics`
(per-epoch gate with early stop). Wired into `Model.fit(callbacks=...)` —
train and epoch hooks fire; an `on_epoch_end` returning truthy stops
training (the reference's early-stop contract).
(Twin of `flexflow_tpu/keras/callbacks.py`.)
"""

from __future__ import annotations

import numpy as np


def _gate_value(accuracy) -> float:
    """A plain float is a fraction (this API's get_accuracy convention);
    the reference's ModelAccuracy-style enums (anything with a .value)
    carry percents."""
    if hasattr(accuracy, "value"):
        return float(accuracy.value) / 100.0
    return float(accuracy)


class Callback:
    def __init__(self):
        self.validation_data = None
        self.params = None
        self.model = None

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, batch, logs=None):
        pass

    def on_batch_end(self, batch, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass


class LearningRateScheduler(Callback):
    """schedule(epoch) -> float, applied before each epoch."""

    def __init__(self, schedule):
        super().__init__()
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        if not hasattr(self.model.optimizer, "lr"):
            raise ValueError('Optimizer must have a "lr" attribute.')
        lr = self.schedule(epoch)
        if not isinstance(lr, (float, np.float32, np.float64)):
            raise ValueError(
                'The output of the "schedule" function should be float.')
        # through the FFModel: the rate is a constant of the captured
        # step, which it drops
        self.model.ffmodel.set_learning_rate(lr)
        print("set learning rate ", self.model.optimizer.lr)


class ModelCheckpoint(Callback):
    """Checkpoint during keras-style training, backed by the resilience
    subsystem (atomic commits, reshard-aware restore — resilience/).

    - periodic: every `every_n_epochs` epochs (default 1);
    - save-best-on-metric: with save_best_only=True, only epochs improving
      the monitored metric are saved. monitor="accuracy" (mode max, from
      PerfMetrics.get_accuracy) or "loss" (mode min, the mean monitored
      loss from the perf counters).

    Restore with `model.ffmodel.load_checkpoint(directory)` — onto any
    mesh/Strategy.
    """

    def __init__(self, directory: str, monitor: str = "accuracy",
                 save_best_only: bool = False, every_n_epochs: int = 1,
                 keep: int = 3, verbose: bool = False):
        super().__init__()
        if monitor not in ("accuracy", "loss"):
            raise ValueError(
                f"monitor must be 'accuracy' or 'loss', got {monitor!r}")
        if every_n_epochs < 1:
            raise ValueError("every_n_epochs must be >= 1")
        self.directory = directory
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.every_n_epochs = every_n_epochs
        self.keep = keep
        self.verbose = verbose
        self.best = None
        self.last_saved = None
        self._manager = None

    def _metric(self) -> float:
        pm = self.model.ffmodel.get_perf_metrics()
        if self.monitor == "accuracy":
            return float(pm.get_accuracy())
        return float(pm.get_mean_loss())

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        return (value > self.best if self.monitor == "accuracy"
                else value < self.best)

    def on_train_begin(self, logs=None):
        from ..resilience import ResilienceManager

        ff = self.model.ffmodel
        assert ff is not None, "compile() before fit with ModelCheckpoint"
        self._manager = ResilienceManager(ff, self.directory, keep=self.keep)

    def on_epoch_end(self, epoch, logs=None):
        if (epoch + 1) % self.every_n_epochs != 0:
            return False
        value = self._metric()
        if self.save_best_only and not self._improved(value):
            return False
        if self._improved(value):
            self.best = value
        ff = self.model.ffmodel
        step = ff._py_step()
        # cursor epochs are ABSOLUTE since compile (fit's convention):
        # the inner fit already advanced _epoch_base past this epoch, and
        # the keras-relative `epoch` restarts at 0 on a second fit call
        abs_epoch = int(getattr(ff, "_epoch_base", epoch + 1))
        # async: serialization overlaps the next epoch; commit is atomic
        self._manager.save(step, cursor={"epoch": abs_epoch, "batch": 0})
        self.last_saved = step
        if self.verbose:
            print(f"ModelCheckpoint: saved step {step} "
                  f"({self.monitor}={value:.4f})")
        return False  # never early-stop training

    def on_train_end(self, logs=None):
        if self._manager is not None:
            self._manager.finalize()  # drain the in-flight async save


class Telemetry(Callback):
    """Enable the observability subsystem (telemetry/) for keras-style
    training: Chrome-trace timeline + JSONL metrics under `directory`,
    with one `epoch` record per keras epoch carrying the monitored
    accuracy/loss. The callback twin of --telemetry-dir.

    Artifacts are flushed at every epoch end (live tailing) and finalized
    at train end; the session stays attached to the model, so
    `model.ffmodel.get_telemetry()` reads it back afterwards.
    """

    def __init__(self, directory: str):
        super().__init__()
        self.directory = directory
        self.session = None

    def on_train_begin(self, logs=None):
        ff = self.model.ffmodel
        assert ff is not None, "compile() before fit with Telemetry"
        self.session = ff.enable_telemetry(self.directory)
        self.session.write_manifest(ff)

    def on_epoch_end(self, epoch, logs=None):
        pm = self.model.ffmodel.get_perf_metrics()
        self.session.recorder.record(
            "keras_epoch", epoch=int(epoch),
            accuracy=float(pm.get_accuracy()),
            mean_loss=float(pm.get_mean_loss()))
        self.session.flush()
        return False  # never early-stop training

    def on_train_end(self, logs=None):
        if self.session is not None:
            self.session.write_summary()
            self.session.flush()


class Diagnostics(Callback):
    """Enable the diagnostics subsystem (diagnostics/) for keras-style
    training: strategy explain report, cost-model drift monitoring, and
    run-health anomaly alerts, with artifacts (strategy_report.json/md,
    alerts.jsonl) under `directory` next to the telemetry files. The
    callback twin of --diagnostics; implies telemetry in the same
    directory when no session exists yet.

    `abort_on` lists rule names ("nan_loss", "step_spike",
    "data_wait_stall", "ckpt_stale") that stop training (HealthAbort)
    instead of warning. Both settings default to None — leave unset to
    inherit whatever --drift-threshold / --health-abort-on configured
    (passing values here overrides the flags).
    """

    def __init__(self, directory: str, drift_threshold=None,
                 abort_on=None):
        super().__init__()
        self.directory = directory
        self.drift_threshold = drift_threshold
        self.abort_on = abort_on if abort_on is None else tuple(abort_on)
        self.manager = None

    def on_train_begin(self, logs=None):
        ff = self.model.ffmodel
        assert ff is not None, "compile() before fit with Diagnostics"
        self.manager = ff.enable_diagnostics(
            self.directory, drift_threshold=self.drift_threshold,
            abort_on=self.abort_on)

    def on_train_end(self, logs=None):
        if self.manager is not None:
            session = self.model.ffmodel.get_telemetry()
            if session is not None:
                session.flush()


class VerifyMetrics(Callback):
    """Assert the final train accuracy clears a gate (AE scripts' check)."""

    def __init__(self, accuracy):
        super().__init__()
        self.accuracy = _gate_value(accuracy)

    def on_train_end(self, logs=None):
        got = self.model.ffmodel.get_perf_metrics().get_accuracy()
        assert got >= self.accuracy, (
            f"accuracy gate failed: {got:.4f} < {self.accuracy:.4f}")


class EpochVerifyMetrics(Callback):
    """Per-epoch accuracy gate; returning True from on_epoch_end stops
    training early once the gate is cleared."""

    def __init__(self, accuracy, early_stop: bool = True):
        super().__init__()
        self.accuracy = _gate_value(accuracy)
        self.early_stop = early_stop

    def on_epoch_end(self, epoch, logs=None):
        if not self.early_stop:
            return False
        got = self.model.ffmodel.get_perf_metrics().get_accuracy()
        return got >= self.accuracy
