"""ffscope of the port — op-grain profiling, always-on flight recorder,
hang watchdog (twin of `flexflow_tpu/scope/`).

1. **Op-grain profiling** (profile.py, attribution.py, kineto.py) — a
   sampled capture (``--profile-every K`` / ``model.profile_step()``)
   runs one step eagerly under ``torch.profiler`` and maps its device
   time back to PCG nodes through the ``record_function(node.name)``
   ranges the executor opens, producing per-op ``measured_s`` /
   fidelity next to the strategy report's ``predicted_s`` (kineto.py is
   the twin of the JAX package's xplane.py).
2. **Flight recorder** (flightrec.py, a copy) — an always-on bounded
   ring of the last N telemetry events, dumped atomically as
   ``flight.json`` on crash, SIGTERM, or watchdog firing.
3. **Hang watchdog** (watchdog.py) — a named daemon thread that detects
   a stuck step, names the lagging rank from a file-channel heartbeat
   (never collectives), and optionally aborts.

Import discipline: the flight recorder is stdlib only (the telemetry
dispatchers feed it in every process); torch is imported where tracing
starts.
"""

from . import flightrec  # noqa: F401  (stdlib-only; safe eagerly)

__all__ = ["flightrec", "attribution", "profile", "watchdog", "kineto"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module("." + name, __name__)
    raise AttributeError(name)
