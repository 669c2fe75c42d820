"""Device specification registry (the port's own copy).

A copy of ``repro.core.device_specs`` (which imports no JAX): the port
keeps its own, so that it imports nothing of the JAX package.

Cephalo's planner reasons about devices through two numbers per device —
peak compute throughput and memory capacity — plus link bandwidth for the
cluster. The paper's Table 3 GPUs are registered verbatim so the cluster
experiments (Tables 4/5, Figs 6-9) run against the exact hardware the paper
used, and the H100 the port runs on is registered beside them.  The
reference's TPU entries, its roofline constants and its TPU clusters are
not copied: nothing on the port's path reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Static description of one accelerator model."""

    name: str
    #: peak dense throughput used by the analytic cost model, in TFLOP/s.
    #: For GPUs this is FP32 (the paper trains full precision).
    peak_tflops: float
    #: usable memory capacity in GiB.
    memory_gib: float
    #: HBM bandwidth in GB/s (used by the roofline memory term).
    hbm_gbps: float
    #: generation tag, informational.
    generation: str = ""

    @property
    def memory_bytes(self) -> int:
        return int(self.memory_gib * (1 << 30))

    @property
    def peak_flops(self) -> float:
        return self.peak_tflops * 1e12


#: Paper Table 3 (FP32 TFLOPs, memory). HBM bandwidths from vendor datasheets.
_REGISTRY: Dict[str, DeviceSpec] = {}


def register(spec: DeviceSpec) -> DeviceSpec:
    _REGISTRY[spec.name] = spec
    return spec


# --- Paper's GPUs (Table 3) -------------------------------------------------
P40 = register(DeviceSpec("P40", 11.8, 24.0, 346.0, "Pascal"))
P100 = register(DeviceSpec("P100", 9.3, 12.0, 549.0, "Pascal"))
A6000 = register(DeviceSpec("A6000", 38.7, 48.0, 768.0, "Ampere"))
L4 = register(DeviceSpec("L4", 30.3, 24.0, 300.0, "Ada"))
V100 = register(DeviceSpec("V100", 14.1, 16.0, 900.0, "Volta"))
T4 = register(DeviceSpec("T4", 8.1, 15.0, 320.0, "Turing"))
A10G = register(DeviceSpec("A10G", 31.2, 24.0, 600.0, "Ampere"))

# --- The port's card ----------------------------------------------------------
#: NVIDIA H100 80GB HBM3 (SXM5, 700 W power limit), by the vendor's H100
#: Tensor Core GPU datasheet: 66.9 TFLOP/s FP32 (non-tensor), 80 GB HBM3 at
#: 3.35 TB/s.  FP32 peak, as for the paper's GPUs above.
H100 = register(DeviceSpec("H100", 66.9, 80.0, 3350.0, "Hopper"))
#: The same card's dense bf16 tensor-core peak, 989.4 TFLOP/s without
#: sparsity (the vendor's H100 Tensor Core GPU datasheet, SXM5 column:
#: "BF16 Tensor Core 1,979 teraFLOPS*", * with sparsity).  The roofline's
#: compute term (``repro_torch.roofline``) divides by it.
H100_BF16_TFLOPS = 989.4
#: The same card's NVLink bandwidth in one direction, GB/s: the datasheet
#: gives "NVLink: 900GB/s" (SXM5), both directions together, over its 18
#: fourth-generation links.  The roofline's collective term divides by it.
H100_NVLINK_GBPS = 450.0


def get(name: str) -> DeviceSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown device {name!r}; known: {sorted(_REGISTRY)}") from None


def known_devices() -> List[str]:
    return sorted(_REGISTRY)


@dataclasses.dataclass(frozen=True)
class Cluster:
    """A (possibly heterogeneous) collection of devices.

    ``devices[i]`` is the spec of rank *i*.  ``link_gbps`` is the slowest
    inter-node link bandwidth, which bounds collective throughput for the
    ring-style AllGather/ReduceScatter the cost model assumes.
    """

    devices: Sequence[DeviceSpec]
    link_gbps: float = 50.0
    name: str = "cluster"
    #: achieved fraction of NIC line rate for cross-node NCCL.  Lab links
    #: (Cluster A) run near line rate; AWS TCP without EFA achieves a
    #: fraction of it (calibrated against the paper's Fig. 8 ratios).
    link_efficiency: float = 1.0
    gpus_per_node: int = 4

    def __post_init__(self):
        if not self.devices:
            raise ValueError("cluster must have at least one device")

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def total_memory_bytes(self) -> int:
        return sum(d.memory_bytes for d in self.devices)

    @property
    def total_peak_flops(self) -> float:
        return sum(d.peak_flops for d in self.devices)

    @property
    def homogeneous(self) -> bool:
        return len({d.name for d in self.devices}) == 1

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.devices:
            out[d.name] = out.get(d.name, 0) + 1
        return out

    def describe(self) -> str:
        parts = [f"{v}x{k}" for k, v in sorted(self.counts().items())]
        return f"{self.name}[{', '.join(parts)}] @ {self.link_gbps} Gbps"


def cluster_a() -> Cluster:
    """Paper Cluster A: 2 machines / 8 GPUs, 50 Gbps inter-node link."""
    return Cluster(
        devices=[L4, L4, A6000, P40, P40, P40, P100, P100],
        link_gbps=50.0,
        name="cluster-a",
        gpus_per_node=4,
    )


def cluster_b() -> Cluster:
    """Paper Cluster B: 8 VMs / 64 GPUs, 100 Gbps network."""
    devices = [A10G] * 16 + [V100] * 16 + [T4] * 32
    return Cluster(devices=devices, link_gbps=100.0, name="cluster-b",
                   link_efficiency=0.25, gpus_per_node=8)


def cluster_b_subset(a10g: int = 16, v100: int = 0, t4: int = 0) -> Cluster:
    """Subsets of Cluster B used by the Fig. 6 scaling experiment."""
    devices = [A10G] * a10g + [V100] * v100 + [T4] * t4
    return Cluster(devices=devices, link_gbps=100.0,
                   name=f"cluster-b-{a10g}a10g-{v100}v100-{t4}t4",
                   link_efficiency=0.25, gpus_per_node=8)


def homogeneous_a10g(n: int = 32) -> Cluster:
    """Fig. 6 right: homogeneous 32xA10G comparison cluster."""
    return Cluster(devices=[A10G] * n, link_gbps=100.0,
                   name=f"homog-{n}xa10g", link_efficiency=0.25,
                   gpus_per_node=8)


def v100_cluster(n: int = 16) -> Cluster:
    """Paper Fig. 8 cluster: homogeneous AWS V100s (2x p3.16xlarge)."""
    return Cluster(devices=[V100] * n, link_gbps=100.0,
                   name=f"{n}xv100", link_efficiency=0.25,
                   gpus_per_node=8)
