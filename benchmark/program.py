"""The benchmark's only contact with the program under test
(`flexflow_tpu_torch`): build a model as a user does, write the seed's
weights into its master tensors, and start its serving engine.

`FFConfig` reads its flags from the command line, so the traffic's
`program_flags`, the batch, the seed and the device are handed to it as
one, and the harness's own arguments are put back afterwards.
"""

from __future__ import annotations

import sys

from reference import gpt as ref


def _ffconfig(traffic: dict, batch: int, seed: int, device: str):
    argv = sys.argv
    sys.argv = ([argv[0]] + list(traffic.get("program_flags", []))
                + ["-b", str(int(batch)), "--seed", str(int(seed)),
                   "--device", device])
    try:
        from flexflow_tpu_torch import FFConfig

        return FFConfig()
    finally:
        sys.argv = argv


def _lm(ff, config: dict, batch: int):
    from flexflow_tpu_torch.models.transformer import (
        TransformerLMConfig, build_transformer_lm)

    m = config["model"]
    build_transformer_lm(ff, TransformerLMConfig(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        num_heads=m["num_heads"], num_layers=m["num_layers"],
        mlp_ratio=m["mlp_ratio"], sequence_length=m["sequence_length"],
        attention_impl="flash"), batch_size=batch)


def build_train_model(config: dict, traffic: dict, seed: int, device: str):
    """The LM compiled for training with the program's Adam and sparse
    cross-entropy, its loss kept by the sparse-CE metric counter."""
    from flexflow_tpu_torch import FFModel
    from flexflow_tpu_torch.fftype import LossType, MetricsType
    from flexflow_tpu_torch.optimizer import AdamOptimizer

    b = int(traffic["batch"])
    ff = FFModel(_ffconfig(traffic, b, seed, device))
    _lm(ff, config, b)
    o = traffic["optimizer"]
    ff.compile(AdamOptimizer(alpha=o["alpha"], beta1=o["beta1"],
                             beta2=o["beta2"], weight_decay=o["weight_decay"],
                             epsilon=o["epsilon"]),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return ff


def build_serve_model(config: dict, traffic: dict, seed: int, device: str):
    """The LM compiled with the defaults (as a model loaded to be served),
    one row a batch: the engine builds its own decode graph from it."""
    from flexflow_tpu_torch import FFModel

    ff = FFModel(_ffconfig(traffic, 1, seed, device))
    _lm(ff, config, 1)
    ff.compile()
    return ff


def make_engine(ff, traffic: dict, config: dict):
    return ff.serve(slots=int(traffic["slots"]),
                    prefill_chunk=int(traffic["prefill_chunk"]),
                    max_seq_len=int(config["model"]["sequence_length"]),
                    kv_block_size=int(traffic["kv_block_size"]),
                    eos_id=None)


def write_weights(ff, shape, seed: int, device):
    """The seed's weights into the program's master tensors, in place, one
    draw group at a time."""
    import torch

    with torch.no_grad():
        for g in ref.groups(shape):
            for (node, w), t in ref.make_group(shape, seed, g,
                                               device).items():
                dst = ff._params[node][w]
                if tuple(dst.shape) != tuple(t.shape):
                    raise ValueError(f"{node}.{w}: program {tuple(dst.shape)}"
                                     f" != reference {tuple(t.shape)}")
                dst.copy_(t)
