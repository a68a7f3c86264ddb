"""Persistent calibration DB: on-chip op measurements that survive restarts
(twin of `flexflow_tpu/warmstart/calibration_db.py`).

`CostModel.calibrate` is the expensive half of a searched compile — each
measured op runs CUDA graphs of its forward and backward on the card. The
measurements are keyed by `_params_key(node)` = (op type, params repr,
unsharded input shapes) and are device-specific but run-independent, so
they persist under

    <warmstart-dir>/calibration.json
    {"version": 1,
     "devices": {"<platform>/<device_kind>": {"<key json>": [fwd, bwd]}}}

Loaded into the CostModel BEFORE `calibrate_graph` runs, so calibration
only measures misses (the reference's simulator cache, made durable).
Entries never overwrite an in-memory measurement (fresher wins), and a
corrupt/unreadable DB degrades to an empty one with a warning — a cache
must never be able to fail a compile.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..telemetry import log as fflog

_DB_NAME = "calibration.json"


def serialize_key(key) -> str:
    """(OperatorType, params repr, shapes tuple) → stable JSON string."""
    op_type, params_repr, shapes = key
    return json.dumps(
        [op_type.name, params_repr, [list(s) for s in shapes]])


def deserialize_key(s: str):
    """The key `serialize_key` wrote; a kind the port has no op for (the
    elastic fidelity entry's OP_NOOP) keeps the JAX package's name."""
    from ..fftype import OperatorType, UnportedOperatorType

    op_name, params_repr, shapes = json.loads(s)
    kind = (OperatorType[op_name] if op_name in OperatorType.__members__
            else UnportedOperatorType[op_name])
    return (kind, params_repr,
            tuple(tuple(int(d) for d in shape) for shape in shapes))


def device_key(device=None) -> str:
    from .fingerprint import device_signature

    d = device_signature(device)
    return f"{d['platform']}/{d['device_kind']}"


class CalibrationDB:
    def __init__(self, directory: str, device=None):
        self.path = os.path.join(os.path.abspath(directory), _DB_NAME)
        self.device = device

    def _read(self) -> dict:
        """The whole on-disk DB ({} when absent/corrupt — with a warning,
        never an exception)."""
        try:
            with open(self.path) as f:
                data = json.load(f)
            if not isinstance(data, dict) or "devices" not in data:
                raise ValueError("not a calibration DB")
            return data
        except FileNotFoundError:
            return {"version": 1, "devices": {}}
        except (OSError, ValueError) as e:
            fflog.warning(
                "warmstart: calibration DB %s unreadable (%s) — starting "
                "empty", self.path, e)
            return {"version": 1, "devices": {}}

    def load_into(self, cost_model) -> int:
        """Merge this device's persisted measurements into the cost model
        (in-memory entries win). Returns the number of entries loaded."""
        entries = self._read().get("devices", {}).get(
            device_key(self.device), {})
        loaded = 0
        for key_s, val in entries.items():
            try:
                key = deserialize_key(key_s)
                fwd, bwd = float(val[0]), float(val[1])
            except (ValueError, KeyError, TypeError, IndexError):
                fflog.warning(
                    "warmstart: skipping malformed calibration entry %r",
                    key_s[:80])
                continue
            if key not in cost_model._calibration:
                cost_model._calibration[key] = (fwd, bwd)
                loaded += 1
        if loaded:
            # cached roofline costs predating the load are stale now
            cost_model._cache.clear()
        return loaded

    def save_from(self, cost_model) -> Optional[int]:
        """Persist the cost model's measurements (merged over the on-disk
        DB, atomic tmp+rename). Coordinator-only: callers gate on
        `distributed.is_coordinator()`. Returns entries written, or None
        when the write failed (warned, not raised)."""
        try:
            data = self._read()
            dev = data.setdefault("devices", {}).setdefault(
                device_key(self.device), {})
            for key, (fwd, bwd) in cost_model._calibration.items():
                dev[serialize_key(key)] = [float(fwd), float(bwd)]
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = f"{self.path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
            return len(dev)
        except OSError as e:
            fflog.warning(
                "warmstart: could not persist calibration DB %s: %s",
                self.path, e)
            return None

    def save_entries(self, cost_model, keys) -> Optional[int]:
        """Persist ONLY the given `_params_key`s (merged over the
        on-disk DB, atomic tmp+rename) — ffscope's targeted refresh:
        an op-grain drift advisory re-measured one op, so exactly that
        op's DB entry is rewritten and every other persisted entry is
        left untouched. Coordinator-only, like save_from. Returns
        entries written, or None on failure (warned, not raised)."""
        try:
            data = self._read()
            dev = data.setdefault("devices", {}).setdefault(
                device_key(self.device), {})
            written = 0
            for key in keys:
                val = cost_model._calibration.get(key)
                if val is None:
                    continue
                dev[serialize_key(key)] = [float(val[0]), float(val[1])]
                written += 1
            if not written:
                return 0
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = f"{self.path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
            return written
        except OSError as e:
            fflog.warning(
                "warmstart: could not persist calibration entries %s: %s",
                self.path, e)
            return None
