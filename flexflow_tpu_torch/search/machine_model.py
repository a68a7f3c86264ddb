"""Chip specs of the port's machine model (twin of the `ChipSpec` table
of `flexflow_tpu/search/machine_model.py:26-45`).

`ChipSpec` is a copy of the JAX package's, field for field, so the
collective and roofline costs that A7 ports read the same numbers. The
H100 stands in for a TPU chip: NVLink takes the place of the ICI links
(18 links of 25 GB/s each way per H100 SXM). The figures are NVIDIA's
published H100 SXM ones (dense bf16 peak, HBM3 rate and size), the ones
`chip_smoke.py` and PERF.md divide by. The collective cost model itself
is ROADMAP A7.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float      # bf16 FLOP/s
    hbm_bandwidth: float   # B/s
    hbm_bytes: float       # device memory capacity
    ici_bandwidth: float   # B/s per link direction (NVLink on a GPU)
    ici_links: int         # links per chip
    ici_latency: float = 1e-6
    dcn_bandwidth: float = 25e9 / 8  # per-host, conservative
    dcn_latency: float = 10e-6


CHIPS = {
    # NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
    # 80 GB; NVLink 4: 18 links, 900 GB/s in all both ways
    "h100": ChipSpec("h100", 989e12, 3.35e12, 80e9, 25e9, 18),
    # the JAX package's host entry, for runs on the CPU
    "cpu": ChipSpec("cpu", 2e11, 5e10, 32e9, 1e10, 2),
}


def detect_chip(device: torch.device | str = "cuda") -> ChipSpec:
    """The spec of `device`: the card `torch.cuda.get_device_name` names,
    or the host entry for the CPU. A card the table does not hold raises:
    no other card's peak stands in for it."""
    device = torch.device(device)
    if device.type == "cpu":
        return CHIPS["cpu"]
    name = torch.cuda.get_device_name(device)
    # the SXM part's name; an H100 PCIe or NVL has a lower peak and rate
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return CHIPS["h100"]
    raise ValueError(f"no chip spec for {name!r} (flexflow_tpu_torch/"
                     f"search/machine_model.py holds: {sorted(CHIPS)})")


def card_line(index: int = 0) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them: a
    card may be set below its maximum power and then runs slower, so a
    time is kept beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[index]
