"""The Unity search's machine model (twin of
`flexflow_tpu/search/machine_model.py`): compute roofline plus collective
costs over the mesh's named axes.

`ChipSpec`, `CHIPS`' TPU entries, `TPUMachineModel`, `AxisTopology`,
`TorusMachineModel`, `machine_model_from_file` and `machine_model_for_mesh`
are copies of the JAX package's, so the two packages price the same mesh
on the same chip identically. Collective costs over an axis of n devices,
per-device payload B bytes, per-direction rate bw and per-step latency a:

  all_gather / reduce_scatter  (n-1)/n * B_full / bw + (n-1) a
  all_reduce                   2 (n-1)/n * B / bw + 2 (n-1) a
  all_to_all                   (n-1)/n * B / bw + (n-1) a
  ppermute (one hop)           B / bw + a

The H100 is not a torus. `NVSwitchMachineModel` prices it, after the
reference's SimpleMachineModel (intra-node and inter-node rates,
simulator.h:212-615), with these figures:

- Inside a node, NVLink 4 through NVSwitch: each H100 SXM has 18 links of
  25 GB/s each way (NVIDIA H100 data sheet: 900 GB/s NVLink in all, both
  ways), and the switch gives every GPU that full 450 GB/s each way to
  any other, so every intra-node axis runs its ring at 450 GB/s: no
  wraparound term, no per-axis split of the links, no fold over two
  dimensions.
- Between nodes, the `dcn` axis (and the outermost axis of a multi-node
  mesh that names none): InfiniBand NDR, one 400 Gb/s (50 GB/s each way)
  ConnectX-7 per GPU (NVIDIA DGX H100 data sheet: eight single-port
  ConnectX-7 400 Gb/s NICs for eight GPUs), so no NIC is shared and no
  fan-in term applies; 10 us a step.
- Compute: 989 TFLOP/s dense bf16 and 3.35 TB/s HBM3, 80 GB (H100 SXM
  data sheet), the figures chip_smoke.py and PERF.md divide by.

`detect_chip` stays strict where the JAX package falls back to v5p: a card
the table does not hold raises.
"""

from __future__ import annotations

import json
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
    "v5e": ChipSpec("v5e", 197e12, 8.1e11, 16e9, 4.5e10, 4),
    "v5p": ChipSpec("v5p", 459e12, 2.765e12, 95e9, 9e10, 6),
    "v4": ChipSpec("v4", 275e12, 1.2e12, 32e9, 4.5e10, 6),
    "v6e": ChipSpec("v6e", 918e12, 1.64e12, 32e9, 9e10, 4),
    "cpu": ChipSpec("cpu", 2e11, 5e10, 32e9, 1e10, 2),
    # NVIDIA H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB;
    # NVLink 4, 18 links of 25 GB/s each way; one 400 Gb/s NIC per GPU
    "h100": ChipSpec("h100", 989e12, 3.35e12, 80e9, 25e9, 18,
                     dcn_bandwidth=50e9),
}


def _local_device(mesh=None):
    """The device a mesh lives on, else the card when there is one (the
    JAX package's `jax.devices()[0]`)."""
    dev = getattr(mesh, "device", None)
    if dev is not None:
        return dev
    return "cuda" if torch.cuda.is_available() else "cpu"


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


@dataclass
class TPUMachineModel:
    """Collective cost oracle over the mesh's named axes.

    `axis_links[axis]` = number of physical links serving that mesh axis
    (a mesh axis folded over 2 torus dims gets 2x bandwidth); axes that
    span hosts use DCN instead (axis_over_dcn)."""

    chip: ChipSpec
    axis_sizes: dict  # axis name -> size
    axis_links: dict | None = None
    axis_over_dcn: frozenset = frozenset()
    # per-axis bandwidth derating for shared paths (EnhancedMachineModel's
    # congestion, simulator.h:279): 1.0 = dedicated, >1 divides the rate
    axis_congestion: dict | None = None

    def _bw(self, axis: str) -> float:
        cong = (self.axis_congestion or {}).get(axis, 1.0)
        if axis in self.axis_over_dcn:
            return self.chip.dcn_bandwidth / cong
        links = (self.axis_links or {}).get(axis, 1)
        return self.chip.ici_bandwidth * links / cong

    def _lat(self, axis: str) -> float:
        return (self.chip.dcn_latency if axis in self.axis_over_dcn
                else self.chip.ici_latency)

    def axis_size(self, axis: str) -> int:
        return self.axis_sizes.get(axis, 1)

    def all_gather(self, out_bytes: float, axis: str) -> float:
        n = self.axis_size(axis)
        if n <= 1:
            return 0.0
        return (n - 1) / n * out_bytes / self._bw(axis) + (n - 1) * self._lat(axis)

    def reduce_scatter(self, in_bytes: float, axis: str) -> float:
        return self.all_gather(in_bytes, axis)

    def all_reduce(self, bytes_per_chip: float, axis: str) -> float:
        n = self.axis_size(axis)
        if n <= 1:
            return 0.0
        return (2.0 * (n - 1) / n * bytes_per_chip / self._bw(axis)
                + 2 * (n - 1) * self._lat(axis))

    def all_to_all(self, send_bytes_per_chip: float, axis: str) -> float:
        n = self.axis_size(axis)
        if n <= 1:
            return 0.0
        return ((n - 1) / n * send_bytes_per_chip / self._bw(axis)
                + (n - 1) * self._lat(axis))

    def ppermute(self, bytes_per_chip: float, axis: str) -> float:
        return bytes_per_chip / self._bw(axis) + self._lat(axis)

    def rotate(self, bytes_per_chip: float, axis: str) -> float:
        """One ring-rotation step, the wrap pair included (ring
        attention's K/V hop): a ppermute on a uniform axis."""
        return self.ppermute(bytes_per_chip, axis)

    def compute_time(self, flops: float, bytes_touched: float) -> float:
        """Roofline: the larger of the math time and the memory time."""
        return max(flops / self.chip.peak_flops,
                   bytes_touched / self.chip.hbm_bandwidth)


@dataclass
class NVSwitchMachineModel(TPUMachineModel):
    """GPUs of a node behind NVSwitch, nodes joined by InfiniBand (the
    module note has the figures). Every intra-node axis runs its ring
    collectives at the GPU's whole NVLink rate (ici_links x
    ici_bandwidth each way): a switch has no torus dimensions to fold an
    axis over, no wraparound edge and no links owned by one axis. A DCN
    axis runs at the GPU's own NIC rate (`chip.dcn_bandwidth`)."""

    def _bw(self, axis: str) -> float:
        cong = (self.axis_congestion or {}).get(axis, 1.0)
        if axis in self.axis_over_dcn:
            return self.chip.dcn_bandwidth / cong
        return self.chip.ici_bandwidth * self.chip.ici_links / cong


@dataclass(frozen=True)
class AxisTopology:
    """Physical shape of one mesh axis on a torus: `links` per chip serve
    it, wrapped (a full-pod dimension) or open (a sub-slice), or on
    DCN."""

    links: int = 1
    wraparound: bool = True
    over_dcn: bool = False


@dataclass
class TorusMachineModel(TPUMachineModel):
    """Topology-aware collective pricing on a (partial) torus:

    - ring collectives on a WRAPPED axis use both ring directions: twice
      the rate of an open axis;
    - all_to_all pays minimal-route hop-bytes: mean distance n/4 on a
      wrapped ring, (n^2-1)/3n on an open line;
    - rotate on an open axis pays the wrap pair's (n-1) serialized hops;
    - a DCN axis shares each host's NIC among its `chips_per_host` chips.
    """

    topology: dict | None = None       # axis -> AxisTopology
    chips_per_host: int = 1            # DCN NIC fan-in

    def _topo(self, axis: str) -> AxisTopology:
        t = (self.topology or {}).get(axis)
        if t is not None:
            return t
        return AxisTopology(links=(self.axis_links or {}).get(axis, 1),
                            wraparound=True,
                            over_dcn=axis in self.axis_over_dcn)

    def _cong(self, axis: str) -> float:
        return (self.axis_congestion or {}).get(axis, 1.0)

    def _link_bw(self, axis: str) -> float:
        """Per-direction bandwidth x parallel links serving the axis."""
        t = self._topo(axis)
        if t.over_dcn:
            return self.chip.dcn_bandwidth / (
                max(1, self.chips_per_host) * self._cong(axis))
        return self.chip.ici_bandwidth * t.links / self._cong(axis)

    def _ring_bw(self, axis: str) -> float:
        t = self._topo(axis)
        bw = self._link_bw(axis)
        if t.over_dcn:
            return bw  # DCN is switched, not a torus: direction-agnostic
        return bw * (2 if t.wraparound else 1)

    def _lat(self, axis: str) -> float:
        return (self.chip.dcn_latency if self._topo(axis).over_dcn
                else self.chip.ici_latency)

    def all_gather(self, out_bytes: float, axis: str) -> float:
        n = self.axis_size(axis)
        if n <= 1:
            return 0.0
        return ((n - 1) / n * out_bytes / self._ring_bw(axis)
                + (n - 1) * self._lat(axis))

    def all_reduce(self, bytes_per_chip: float, axis: str) -> float:
        n = self.axis_size(axis)
        if n <= 1:
            return 0.0
        return (2.0 * (n - 1) / n * bytes_per_chip / self._ring_bw(axis)
                + 2 * (n - 1) * self._lat(axis))

    def all_to_all(self, send_bytes_per_chip: float, axis: str) -> float:
        """Wrapped ring (even n): B n / (8 link_bw); open line:
        B (n+1) / (6 link_bw); DCN: (n-1)/n B over the NIC."""
        n = self.axis_size(axis)
        if n <= 1:
            return 0.0
        t = self._topo(axis)
        bw = self._link_bw(axis)
        lat = self._lat(axis)
        if t.over_dcn:
            return (n - 1) / n * send_bytes_per_chip / bw + (n - 1) * lat
        if t.wraparound:
            time = send_bytes_per_chip * n / (8 * bw)
        else:
            time = send_bytes_per_chip * (n + 1) / (6 * bw)
        return time + (n - 1) * lat

    def ppermute(self, bytes_per_chip: float, axis: str) -> float:
        """Neighbor hop (no wrap edge): a pipeline stage hand-off."""
        return bytes_per_chip / self._link_bw(axis) + self._lat(axis)

    def rotate(self, bytes_per_chip: float, axis: str) -> float:
        n = self.axis_size(axis)
        t = self._topo(axis)
        hop = bytes_per_chip / self._link_bw(axis) + self._lat(axis)
        if t.over_dcn or t.wraparound or n <= 2:
            return hop
        return (n - 1) * hop


def _switched(chip: ChipSpec) -> bool:
    return chip.name == "h100"


def machine_model_from_file(path: str, mesh) -> TPUMachineModel:
    """--machine-model-file: a JSON description of the machine overriding
    the detected chip and the topology defaults.

      {"chip": "v5p" | "h100"             # a CHIPS name, or an object:
               | {"name": ..., "peak_flops": ..., "hbm_bandwidth": ...,
                  "hbm_bytes": ..., "ici_bandwidth": ..., "ici_links": ...,
                  ["ici_latency", "dcn_bandwidth", "dcn_latency"]},
       "axis_links": {"data": 2, ...},    # torus links per mesh axis
       "dcn_axes": ["dcn"],               # axes that ride DCN
       "congestion": {"dcn": 2.0},        # per-axis rate derating (>= 1)
       "topology": {"data": {"wraparound": false, "links": 2}},
       "chips_per_host": 4}               # DCN NIC fan-in

    An "h100" chip gives the switch model (links, topology and fan-in
    do not apply to it); the others the torus."""
    with open(path) as f:
        data = json.load(f)
    chip_cfg = data.get("chip", None)
    if chip_cfg is None:
        chip = detect_chip(_local_device(mesh))
    elif isinstance(chip_cfg, str):
        if chip_cfg not in CHIPS:
            raise ValueError(
                f"machine model file {path}: unknown chip {chip_cfg!r}; "
                f"have {sorted(CHIPS)}")
        chip = CHIPS[chip_cfg]
    else:
        name = chip_cfg.get("name", "custom")
        base = CHIPS.get(name)
        core = ("peak_flops", "hbm_bandwidth", "hbm_bytes",
                "ici_bandwidth", "ici_links")
        if base is None and not all(f in chip_cfg for f in core):
            missing = [f for f in core if f not in chip_cfg]
            raise ValueError(
                f"machine model file {path}: chip name {name!r} is not a "
                f"known base ({sorted(CHIPS)}) and the spec is missing "
                f"{missing}")
        base = base or CHIPS["v5p"]
        fields = {f: chip_cfg.get(f, getattr(base, f))
                  for f in ("name", "peak_flops", "hbm_bandwidth",
                            "hbm_bytes", "ici_bandwidth", "ici_links",
                            "ici_latency", "dcn_bandwidth", "dcn_latency")}
        fields["name"] = name
        chip = ChipSpec(**fields)
    from ..machine import AXIS_DCN

    axis_sizes = dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)
    links = {a: 1 for a in axis_sizes}
    links.update({a: int(v) for a, v in data.get("axis_links", {}).items()
                  if a in links})
    # the canonical dcn axis always rides DCN, with or without a file entry
    over_dcn = {a for a in data.get("dcn_axes", ()) if a in axis_sizes}
    over_dcn |= {a for a in axis_sizes if a == AXIS_DCN}
    unknown = [a for a in data.get("congestion", {}) if a not in axis_sizes]
    if unknown:
        raise ValueError(
            f"machine model file {path}: congestion axes {unknown} not in "
            f"the mesh (have {sorted(axis_sizes)})")
    congestion = {a: float(v) for a, v in data.get("congestion", {}).items()}
    bad = {a: v for a, v in congestion.items() if v < 1.0}
    if bad:
        raise ValueError(
            f"machine model file {path}: congestion factors must be >= 1 "
            f"(bandwidth derating), got {bad}")
    topo_cfg = data.get("topology", {})
    unknown = [a for a in topo_cfg if a not in axis_sizes]
    if unknown:
        raise ValueError(
            f"machine model file {path}: topology axes {unknown} not in "
            f"the mesh (have {sorted(axis_sizes)})")
    if _switched(chip):
        return NVSwitchMachineModel(chip, axis_sizes, links,
                                    frozenset(over_dcn), congestion or None)
    topology = {}
    for a in axis_sizes:
        spec = topo_cfg.get(a, {})
        topology[a] = AxisTopology(
            links=int(spec.get("links", links.get(a, 1))),
            wraparound=bool(spec.get("wraparound", a not in over_dcn)),
            over_dcn=a in over_dcn)
    if "chips_per_host" in data:
        chips_per_host = max(1, int(data["chips_per_host"]))
    else:
        # chips / hosts (hosts = product of the DCN axes)
        total = hosts = 1
        for a, v in axis_sizes.items():
            total *= v
            if a in over_dcn:
                hosts *= v
        chips_per_host = max(1, total // hosts) if hosts > 1 else 1
    return TorusMachineModel(
        chip, axis_sizes, links, frozenset(over_dcn), congestion or None,
        topology=topology, chips_per_host=chips_per_host)


def machine_model_for_mesh(mesh, chip: ChipSpec | None = None,
                           num_hosts: int = 1) -> TPUMachineModel:
    """The analytic machine of `mesh` (a Mesh, anything with `.shape`, or
    a dict of axis sizes) on `chip` (default: the mesh's device's): the
    switch model for the H100, the torus for the TPU chips."""
    from ..machine import AXIS_DCN

    chip = chip or detect_chip(_local_device(mesh))
    axis_sizes = dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)
    # collectives on the dedicated DCN axis cross the data-center network
    over_dcn = {a for a in axis_sizes if a == AXIS_DCN}
    if num_hosts > 1 and not over_dcn and axis_sizes:
        # a multi-host run without a dcn axis: the outermost axis spans
        # hosts
        over_dcn.add(next(iter(axis_sizes)))
    links = {a: 1 for a in axis_sizes}
    if _switched(chip):
        return NVSwitchMachineModel(chip, axis_sizes, links,
                                    frozenset(over_dcn))
    # the largest ICI axis folds over 2 torus dims when the chip has > 4
    # links (v5p's 3D torus)
    ici_axes = [a for a in axis_sizes if a not in over_dcn]
    if chip.ici_links >= 6 and ici_axes:
        big = max(ici_axes, key=lambda a: axis_sizes[a])
        links[big] = 2
    topology = {a: AxisTopology(links=links[a], wraparound=a not in over_dcn,
                                over_dcn=a in over_dcn)
                for a in axis_sizes}
    total = 1
    for v in axis_sizes.values():
        total *= v
    chips_per_host = max(1, total // max(1, num_hosts)) if num_hosts > 1 else 1
    return TorusMachineModel(chip, axis_sizes, links, frozenset(over_dcn),
                             topology=topology,
                             chips_per_host=chips_per_host)
