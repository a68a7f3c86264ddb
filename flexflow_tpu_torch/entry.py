"""Entry points of the port (the twin of `__graft_entry__.py`).

- `entry()`: the tiny Transformer LM's forward on one device, and its
  example arguments.
- `dryrun_multichip(n)`: one full training step of the tiny LM over an
  n-device mesh, data x tensor x sequence parallel as the JAX dry run
  factors it (tp divides the heads, sp takes the next small prime, the
  rest is dp; the sequence scaled by sp, ring attention where sp > 1;
  `megatron_transformer`), on the ranks of the torch.distributed world.
  Started by `torchrun --nproc-per-node n` it runs on each rank's card;
  with `device="cpu"` and no such world it spawns n gloo ranks on the
  CPU (the JAX entry respawns itself onto a virtual n-device CPU mesh);
  asked for a card with no such world, it raises. The "sp" leg runs the
  same LM under `sequence_parallel_attention` too, so its activations
  stay split over the sequence between the attention layers. The "moe"
  leg is the JAX dry run's dp x ep step (`__graft_entry__.py:174-195`):
  the fused MoE under `expert_parallel_moe`, its experts over `model`
  (ep = the LM's tp), the batch over `data`.
"""

from __future__ import annotations

import sys

import numpy as np

# head count of the dry run's LM: tensor parallelism must divide it
_DRYRUN_NUM_HEADS = 4


def _clean_argv():
    # FFConfig parses sys.argv; the caller's own argv must not leak in
    sys.argv = [sys.argv[0] if sys.argv else "entry"]


def _lm_setup(batch, seq, mesh_axes=None, attention_impl="xla",
              strategy_fns=(), device="cuda", flags=()):
    from . import FFConfig, FFModel, LossType, SGDOptimizer
    from .models import TransformerLMConfig, build_transformer_lm

    config = FFConfig(device=device)
    config.batch_size = batch
    config.parse_args(list(flags))
    if mesh_axes is not None:
        config.mesh_axis_sizes = mesh_axes
    ff = FFModel(config)
    c = TransformerLMConfig(
        vocab_size=512, hidden_size=128, num_heads=_DRYRUN_NUM_HEADS,
        num_layers=2, sequence_length=seq, attention_impl=attention_impl,
    )
    build_transformer_lm(ff, c, batch_size=batch)
    strat = None
    for fn in strategy_fns:
        s = fn(ff)
        strat = s if strat is None else strat.merge(s)
    if strat is not None:
        ff.set_strategy(strat)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff, c


def entry(device: str = "cuda"):
    """Returns (fn, example_args): the tiny LM's forward on `device`."""
    import torch

    _clean_argv()
    batch, seq = 2, 128
    ff, c = _lm_setup(batch, seq, device=device)
    ex = ff.executor

    def fwd(params, tokens, positions):
        with torch.no_grad():
            logits, _ = ex._apply(
                params, {}, {"tokens": tokens, "positions": positions})
        return logits

    tokens = torch.zeros((batch, seq), dtype=torch.int32, device=ff.device)
    positions = torch.arange(seq, dtype=torch.int32,
                             device=ff.device).repeat(batch, 1)
    return fwd, (ff._params, tokens, positions)


def _factor_mesh(n: int, num_heads: int):
    """n devices as dp x tp x sp (JAX `__graft_entry__._factor_mesh`): tp
    the first small prime dividing both n and the head count, sp the
    first small prime dividing what is left, the rest dp."""
    tp = 1
    for f in (2, 3, 5, 7):
        if n % f == 0 and num_heads % f == 0:
            tp = f
            n //= f
            break
    sp = 1
    for f in (2, 3, 5, 7):
        if n % f == 0:
            sp = f
            n //= f
            break
    return n, tp, sp


def _moe_step(dp: int, ep: int, batch: int, device: str) -> float:
    """One training step of the fused MoE (4 experts, top 2, 32 -> 8)
    at dp x ep, its experts over `model` (JAX `__graft_entry__.py:
    174-195`); returns the step's loss."""
    from . import FFConfig, FFModel, LossType, SGDOptimizer, load_params
    from .models import MoeConfig, build_moe
    from .parallel import expert_parallel_moe

    config = FFConfig(device=device)
    config.batch_size = batch
    config.parse_args(["--weight-update-sharding=off"])
    config.mesh_axis_sizes = (dp, ep, 1, 1)
    ff = FFModel(config)
    mc = MoeConfig(num_exp=4, num_select=2, in_dim=32, num_classes=8)
    build_moe(ff, mc, batch_size=batch, fused=True)
    ff.set_strategy(expert_parallel_moe(ff))
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    # weights drawn by layer position, so every process (whatever its
    # layer counter named them) and every mesh steps from the same ones
    rs = np.random.RandomState(0)
    load_params(ff, {l.name: {
        w: rs.uniform(-0.3, 0.3, ff.executor.weight_shape(l.name, w))
        .astype(np.float32) for w in ff._params[l.name]}
        for l in ff.layers if l.name in ff._params})
    step = ff.executor.build_train_step()
    rs = np.random.RandomState(1)
    x = rs.randn(batch, 32).astype(np.float32)
    y = rs.randint(0, 8, (batch, 1)).astype(np.int32)
    staged = ff._make_batch({ff._input_tensors[0].name: x}, y)
    out = step(ff._params, ff._state, ff._opt_slots, ff._step,
               ff._counters, staged, ff._rng)
    return float(out[-1])


def _dryrun_rank(rank: int, n_devices: int, device: str,
                 legs=("lm",)):
    from .parallel import megatron_transformer, sequence_parallel_attention

    _clean_argv()
    dp, tp, sp = _factor_mesh(n_devices, _DRYRUN_NUM_HEADS)
    seq, batch = 128 * sp, 2 * dp
    losses = []
    for leg in legs:
        if leg == "moe":
            # the dp x ep mesh of the same devices: ep = tp, the rest dp
            losses.append(_moe_step(n_devices // tp, tp, 2 * (
                n_devices // tp), device))
            if rank == 0:
                print(f"dryrun MoE ok: mesh dp={n_devices // tp} ep={tp}, "
                      f"loss={losses[-1]:.4f}")
            continue
        fns = (megatron_transformer,)
        if leg == "sp":
            fns += (sequence_parallel_attention,)
        ff, c = _lm_setup(batch, seq, mesh_axes=(dp, tp, 1, sp),
                          attention_impl="ring" if sp > 1 else "xla",
                          strategy_fns=fns, device=device,
                          flags=("--weight-update-sharding=off",))
        step = ff.executor.build_train_step()
        rs = np.random.RandomState(0)
        toks = rs.randint(0, c.vocab_size, (batch, seq)).astype(np.int32)
        pos = np.tile(np.arange(seq, dtype=np.int32), (batch, 1))
        labels = rs.randint(0, c.vocab_size,
                            (batch, seq, 1)).astype(np.int32)
        staged = ff._make_batch({"tokens": toks, "positions": pos}, labels)
        out = step(ff._params, ff._state, ff._opt_slots, ff._step,
                   ff._counters, staged, ff._rng)
        losses.append(float(out[-1]))
        if rank == 0:
            print(f"dryrun LM ok ({leg} leg): mesh dp={dp} tp={tp} "
                  f"sp={sp}, loss={losses[-1]:.4f}")
    return losses[0] if len(losses) == 1 else tuple(losses)


def dryrun_multichip(n_devices: int, legs=("lm",), device: str = "cuda"):
    """One training step of the tiny LM over `n_devices` ranks, dp x tp
    x sp, per leg of `legs` ("lm", "sp"; "moe": the fused MoE at dp x
    ep); returns each rank's loss (a
    tuple of them, one a leg, for more than one leg). Without a process group of `n_devices`
    ranks it spawns them on the CPU (gloo) when `device` is "cpu", and
    raises for any other device: it never moves a run the caller asked
    for on a card onto the CPU."""
    import torch
    import torch.distributed as dist

    legs = tuple(legs)
    for leg in legs:
        if leg not in ("lm", "sp", "moe"):
            raise ValueError(f"unknown dry-run leg {leg!r}")
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        return [_dryrun_rank(dist.get_rank(), n_devices, device, legs)]
    if torch.device(device).type != "cpu":
        raise ValueError(
            f"dryrun_multichip({n_devices}) on {device!r} needs a process "
            f"group of {n_devices} ranks, one a card: start them with "
            f"`torchrun --nproc-per-node {n_devices}` (only CPU ranks are "
            f"spawned here, with device=\"cpu\")")
    from .distributed import spawn

    return spawn(_dryrun_rank, n_devices, n_devices, "cpu", legs)
