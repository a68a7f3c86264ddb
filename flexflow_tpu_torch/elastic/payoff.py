"""Payoff rule + migration-fidelity calibration for elastic re-planning
(twin of `flexflow_tpu/elastic/payoff.py`).

The controller migrates exactly when

    predicted_migration_s x fidelity_ratio  <  benefit_s_per_step x horizon

The left side is fftrans's statically priced TransitionPlan seconds scaled
by an online-calibrated *fidelity ratio* (measured / predicted migration
seconds): the transition cost model prices wire bytes and gather work, but
a real `migrate_state` also pays per-leaf dispatch overhead the static
price cannot see. Each completed migration feeds its own measured /
predicted ratio back in (EMA), and the ratio persists in the warm-start
calibration DB under a reserved key of the card's device kind
(`calibration_db.device_key` of the model's device), so it survives
restarts instead of resetting to the default every run (the same
reserved-key idiom as the collective-hop entries,
cost_model._collective_key).
"""

from __future__ import annotations

from ..telemetry import log as fflog

# reserved calibration-DB key (never produced by _params_key: no real op
# carries this params repr). Value is stored in the [fwd, bwd] slots as
# [fidelity_ratio, sample_count].
_FIDELITY_PARAMS = "__migration_fidelity__"
_FIDELITY_SHAPES = ((1,),)

DEFAULT_FIDELITY = 1.0
_EMA_ALPHA = 0.5  # migrations are rare; weight fresh measurements heavily


def _fidelity_key():
    from ..fftype import UnportedOperatorType

    return (UnportedOperatorType.OP_NOOP, _FIDELITY_PARAMS,
            _FIDELITY_SHAPES)


def _calibration_db(model):
    warm = getattr(model, "_warmstart", None)
    if warm is not None:
        return warm.calibration_db
    directory = getattr(model.config, "warmstart_dir", "")
    if directory:
        from ..warmstart.calibration_db import CalibrationDB

        return CalibrationDB(directory, getattr(model, "device", None))
    return None


def load_fidelity(model) -> tuple[float, int]:
    """The model's current (fidelity_ratio, samples): the in-process EMA
    when a migration already ran this process, else the persisted DB entry
    for this device kind, else (DEFAULT_FIDELITY, 0)."""
    mem = getattr(model, "_migration_fidelity", None)
    if mem is not None:
        return float(mem[0]), int(mem[1])
    db = _calibration_db(model)
    if db is not None:
        from ..warmstart.calibration_db import device_key, serialize_key

        entry = (db._read().get("devices", {}).get(device_key(db.device),
                                                   {})
                 .get(serialize_key(_fidelity_key())))
        if entry is not None:
            try:
                ratio, samples = float(entry[0]), int(entry[1])
                if ratio > 0:
                    model._migration_fidelity = (ratio, samples)
                    return ratio, samples
            except (TypeError, ValueError, IndexError):
                pass
    return DEFAULT_FIDELITY, 0


def record_fidelity(model, ratio: float) -> tuple[float, int]:
    """Fold one migration's measured/predicted ratio into the model's
    fidelity EMA and persist it (coordinator-only, fail-soft — a
    calibration write must never fail a migration). Returns the updated
    (ratio, samples)."""
    ratio = float(ratio)
    if not (ratio > 0):
        return load_fidelity(model)
    cur, samples = load_fidelity(model)
    if samples == 0:
        updated = ratio
    else:
        updated = (1 - _EMA_ALPHA) * cur + _EMA_ALPHA * ratio
    model._migration_fidelity = (updated, samples + 1)
    try:
        db = _calibration_db(model)
        if db is not None:
            from ..distributed import is_coordinator

            if is_coordinator():
                import types

                shim = types.SimpleNamespace(_calibration={
                    _fidelity_key(): (updated, float(samples + 1))})
                db.save_from(shim)
    except Exception as e:  # persistence is best-effort
        fflog.warning("elastic: could not persist migration fidelity: %s", e)
    return model._migration_fidelity


def evaluate_payoff(*, predicted_migration_s: float, fidelity_ratio: float,
                    benefit_s_per_step: float, horizon_steps: int,
                    forced: bool = False) -> dict:
    """Both sides of the payoff inequality, as the decision record carries
    them (the doctor's check recomputes lhs/rhs from the factors and
    requires them to reproduce). `forced` (capacity shrink: the compiled
    mesh no longer exists) records the inequality without letting it
    gate."""
    lhs = float(predicted_migration_s) * float(fidelity_ratio)
    rhs = float(benefit_s_per_step) * int(horizon_steps)
    return {
        "predicted_migration_s": float(predicted_migration_s),
        "fidelity_ratio": float(fidelity_ratio),
        "benefit_s_per_step": float(benefit_s_per_step),
        "horizon_steps": int(horizon_steps),
        "lhs_s": lhs,
        "rhs_s": rhs,
        "would_migrate": bool(lhs < rhs),
        "forced": bool(forced),
    }
