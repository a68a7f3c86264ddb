"""`FFModel.compile` through the Unity search on a mesh of 4 gloo ranks on
the CPU, against the JAX package on its virtual 8-device mesh and against
one rank.

One spawn (`flexflow_tpu_torch.distributed.spawn`) runs two models, each
from the JAX model's initial weights (`load_params`), float32:
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

- `--mesh 4,1,1,1` with no other flag (tests/test_weight_update.py's
  MLP, Adam): compile prices the weight-update decision, which must be the
  JAX package's record, the same on every rank, and the model trains;
- `--mesh 2,2,1,1 --budget 4 --enable-parameter-parallel`
  (tests/test_parallel.py's MLP, SGD): rank 0 searches and broadcasts,
  every rank applies the JAX package's plan, and the model trains.

Each run is held to the same model trained on one rank by its masters'
change from the initial weights (`delta_rel`, as chip_smoke.py's mesh
gates: a gradient summed twice or an update skipped reads 1) and by the
metric counters (the summed loss and the correct count).
"""

import json

import numpy as np

from test_torch_distributed import (
    WORLD,
    _spawn,
    build_mlp,
    data,
    port_state,
)

DELTA_REL = 1e-3  # chip_smoke.MESH_TOL["f32"]
DELTA_FLOOR = 1e-2
JOBS = {
    "priced": dict(kind="wu", mesh=(4, 1, 1, 1), argv=[], opt="adam"),
    "searched": dict(kind="tp", mesh=(2, 2, 1, 1), opt="sgd",
                     argv=["--budget", "4", "--enable-parameter-parallel"]),
}


def _plan(ff) -> str:
    from flexflow_tpu_torch.parallel import Strategy

    return json.dumps(Strategy(ff._strategy or {}).to_json(), sort_keys=True)


def search_job(rank, inits) -> dict:
    from flexflow_tpu_torch import load_params

    out = {}
    for name, job in JOBS.items():
        ff = build_mlp("flexflow_tpu_torch", job["kind"], job["mesh"],
                       job["argv"], job["opt"])
        load_params(ff, inits[name])
        x, y = data(job["kind"])
        ff.fit(x, y, epochs=2, batch_size=ff.config.batch_size,
               shuffle=False, verbose=False)
        out[name] = {"state": port_state(ff),
                     "decision": ff._update_sharding,
                     "plan": _plan(ff), "source": ff._plan_source}
    return out


def _one_rank(name, init) -> dict:
    from flexflow_tpu_torch import load_params

    job = JOBS[name]
    ff = build_mlp("flexflow_tpu_torch", job["kind"], (1, 1, 1, 1),
                   job["argv"], job["opt"])
    load_params(ff, init)
    x, y = data(job["kind"])
    ff.fit(x, y, epochs=2, batch_size=ff.config.batch_size, shuffle=False,
           verbose=False)
    return port_state(ff)


def _delta_rel(got, want, init) -> float:
    done = {k: want[k].astype(np.float64) - init[k] for k in want}
    floor = DELTA_FLOOR * max(np.linalg.norm(d) for d in done.values())
    return max(np.linalg.norm(got[k] - init[k] - d)
               / max(np.linalg.norm(d), floor) for k, d in done.items())


def test_priced_and_searched_compiles_train_as_one_rank():
    from flexflow_tpu.parallel import Strategy as JStrategy

    inits, jax_plans, jax_decisions = {}, {}, {}
    for name, job in JOBS.items():
        jff = build_mlp("flexflow_tpu", job["kind"], job["mesh"],
                        job["argv"], job["opt"])
        inits[name] = {n: {k: np.asarray(v) for k, v in ws.items()}
                       for n, ws in jff._params.items()}
        jax_plans[name] = json.dumps(
            JStrategy(jff._strategy or {}).to_json(), sort_keys=True)
        jax_decisions[name] = jff._update_sharding
    outs = _spawn(search_job, inits)
    assert len(outs) == WORLD
    for name in JOBS:
        ref = _one_rank(name, inits[name])
        init = {f"{n}.{k}": v.astype(np.float64)
                for n, ws in inits[name].items() for k, v in ws.items()}
        want = jax_decisions[name]
        for rank, o in enumerate(outs):
            got = o[name]
            assert got["plan"] == jax_plans[name], (name, rank)
            for k in ("enabled", "stage", "shards", "axes", "reason"):
                assert got["decision"][k] == want[k], (name, rank, k)
            assert got["decision"] == outs[0][name]["decision"]
            assert got["source"] == (
                "default" if name == "priced"
                else "search" if rank == 0 else "broadcast")
            st = got["state"]
            assert _delta_rel(st["params"], ref["params"], init) \
                <= DELTA_REL, (name, rank)
            for k, v in ref["counters"].items():
                np.testing.assert_allclose(st["counters"][k], v, rtol=1e-5,
                                           err_msg=f"{name} {k}")
    assert "model" in jax_plans["searched"]
    assert jax_decisions["priced"]["forced"] is None
