"""ffscope of the port: the always-on flight recorder (`flightrec.py`, a
copy of `flexflow_tpu/scope/flightrec.py`, stdlib only), which the
telemetry dispatchers feed. Op-grain profiling and the hang watchdog are
ROADMAP A10."""

from . import flightrec  # noqa: F401

__all__ = ["flightrec"]
