"""Cluster description: open device registry + node list.

The port's copy of ``metis_tpu/cluster/spec.py``.

Replaces the reference's closed ``DeviceType`` enum (A100/V100/P100/T4 only,
``utils.py:46-57`` — adding a type required a code change) and its
``GPUCluster`` façade (``gpu_cluster.py:8-58``) with an open, data-driven
registry, so the whole planner is device-agnostic.  The port registers the
H100 beside the reference's presets; the reference's TPU torus lowering
(``metis_tpu/cluster/tpu.py``) is not ported.

Known reference quirks handled here (SURVEY.md §2.3 / §7):

- ``GPUCluster.get_inter_bandwidth`` returns the *intra* bandwidth field
  (``gpu_cluster.py:52-58``).  ``ClusterSpec.inter_bw_for_types`` reproduces
  that only when ``strict_compat=True``; native mode reads the real field.
- hostfile slot counts were parsed with a ``[6:7]`` slice (single digit only,
  ``utils.py:15``); our parser splits on ``=`` and handles any width.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, replace
from pathlib import Path

from metis_tpu_torch.core.errors import ClusterSpecError


#: Valid availability tiers for a device type.
DEVICE_TIERS = ("reserved", "spot")


@dataclass(frozen=True)
class DeviceSpec:
    """One accelerator type.  Bandwidths in GB/s, memory in GB.

    ``tier``/``preemption_rate_per_hr`` are the availability prior the
    spot-aware cost model prices (``SearchConfig.use_spot_model``): a
    "spot" type may be preempted at the given expected rate, a "reserved"
    type never is (its rate is ignored and treated as 0)."""

    name: str
    memory_gb: float
    intra_bw_gbps: float  # within a node (NVLink) / within a slice (ICI)
    inter_bw_gbps: float  # across nodes (IB/Ethernet) / across slices (DCN)
    hbm_gbps: float = 0.0  # device memory bandwidth; 0 = unknown
    tier: str = "reserved"  # "reserved" | "spot"
    preemption_rate_per_hr: float = 0.0  # expected per-device evictions/hour

    def __post_init__(self) -> None:
        if self.tier not in DEVICE_TIERS:
            raise ClusterSpecError(
                f"device {self.name!r}: tier must be one of {DEVICE_TIERS}, "
                f"got {self.tier!r}")
        if self.preemption_rate_per_hr < 0:
            raise ClusterSpecError(
                f"device {self.name!r}: preemption_rate_per_hr must be >= 0, "
                f"got {self.preemption_rate_per_hr}")

    @property
    def is_spot(self) -> bool:
        return self.tier == "spot"

    @property
    def hazard_per_hr(self) -> float:
        """The rate the spot cost model charges: 0 unless the tier is spot
        (a stale rate on a reserved type must not leak into rankings)."""
        return self.preemption_rate_per_hr if self.tier == "spot" else 0.0

    @property
    def memory_mb(self) -> float:
        # The reference converts GB→MB with ×1024 (gpu_cluster.py:45); profile
        # memory is recorded in MB, so we keep the same convention.
        return self.memory_gb * 1024

    @property
    def effective_hbm_gbps(self) -> float:
        """HBM bandwidth for roofline pricing (decode KV reads).  When the
        clusterfile/registry carries no measured value, fall back to a
        conservative multiple of the intra-node link: accelerator HBM is
        typically 10-40x NVLink/ICI, so 16x keeps decode memory-bound
        without wildly flattering unknown hardware."""
        return self.hbm_gbps if self.hbm_gbps > 0 else 16.0 * self.intra_bw_gbps


# Open registry — callers may register new types at runtime (the reference's
# closed enum is the anti-pattern this replaces).
DEVICE_REGISTRY: dict[str, DeviceSpec] = {}


def register_device(spec: DeviceSpec, overwrite: bool = False) -> DeviceSpec:
    """Add a device type to the process-global registry.  Collisions raise
    unless ``overwrite=True`` — silently clobbering a registered type would
    change every later ClusterSpec lookup in the process."""
    if not overwrite and spec.name in DEVICE_REGISTRY:
        raise ClusterSpecError(f"device type {spec.name!r} already registered")
    DEVICE_REGISTRY[spec.name] = spec
    return spec


# Baseline GPU presets (link bandwidths are placeholders; real runs take
# values from the clusterfile, which overrides these per cluster).  HBM
# bandwidths are the published part numbers (A100-80GB SXM / V100 / P100 /
# T4 / H100 SXM5, 80 GB at 3.35 TB/s) — the decode-phase KV-read roofline
# needs them and clusterfiles predate the field, so from_files backfills
# from here by instance type.  The H100 is the port's own addition.
for _name, _mem, _hbm in [("A100", 80, 2039), ("V100", 16, 900),
                          ("P100", 16, 732), ("T4", 15, 320),
                          ("H100", 80, 3350)]:
    register_device(DeviceSpec(_name, _mem, intra_bw_gbps=50,
                               inter_bw_gbps=10, hbm_gbps=_hbm))


@dataclass(frozen=True)
class NodeSpec:
    """One host: a device type and how many accelerators it carries."""

    device_type: str
    num_devices: int


@dataclass(frozen=True)
class ClusterSpec:
    """An ordered list of nodes plus per-type device specs.

    Node order is the physical rank order (rank = node_index *
    devices_per_node + local index), matching the reference's linear placement
    (``cluster_bandwidth.py:34-47``).
    """

    nodes: tuple[NodeSpec, ...]
    devices: dict[str, DeviceSpec]

    def __post_init__(self) -> None:
        if not self.nodes:
            raise ClusterSpecError("cluster has no nodes")
        for node in self.nodes:
            if node.device_type not in self.devices:
                raise ClusterSpecError(f"no DeviceSpec for {node.device_type!r}")

    # -- counts ------------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def total_devices(self) -> int:
        return sum(n.num_devices for n in self.nodes)

    @property
    def devices_per_node(self) -> int:
        """Uniform node width.  Raises on mixed-width clusters — callers that
        support ragged nodes must use node_of_rank instead (the reference
        silently assumed node 0's width, gpu_cluster.py:25-26)."""
        widths = {n.num_devices for n in self.nodes}
        if len(widths) > 1:
            raise ClusterSpecError(
                f"cluster has mixed node widths {sorted(widths)}; "
                "devices_per_node is undefined")
        return self.nodes[0].num_devices

    @property
    def device_types(self) -> tuple[str, ...]:
        """Unique device types in node order."""
        seen: list[str] = []
        for n in self.nodes:
            if n.device_type not in seen:
                seen.append(n.device_type)
        return tuple(seen)

    def num_devices_by_type(self, device_type: str) -> int:
        return sum(n.num_devices for n in self.nodes if n.device_type == device_type)

    def num_devices_by_tier(self, tier: str) -> int:
        """Devices whose type sits on the given availability tier — the
        spot-exposure accounting the fleet scheduler's price-aware
        carve-up reports per tenant."""
        if tier not in DEVICE_TIERS:
            raise ClusterSpecError(
                f"tier must be one of {DEVICE_TIERS}, got {tier!r}")
        return sum(n.num_devices for n in self.nodes
                   if self.devices[n.device_type].tier == tier)

    def subset(self, node_indices) -> "ClusterSpec":
        """The sub-cluster holding only the nodes at ``node_indices``
        (any order; deduplicated), in the parent's node order so rank
        mapping is preserved — the per-tenant carve the fleet scheduler
        plans on.  The devices dict is narrowed to the surviving types;
        a subset of every node reproduces the parent's node tuple exactly,
        which is what keeps the single-tenant scheduling path
        byte-identical to a direct planner call."""
        indices = sorted(set(int(i) for i in node_indices))
        if not indices:
            raise ClusterSpecError("cannot build an empty sub-cluster")
        if indices[0] < 0 or indices[-1] >= len(self.nodes):
            raise ClusterSpecError(
                f"node index out of range: {indices} vs "
                f"{len(self.nodes)} nodes")
        nodes = tuple(self.nodes[i] for i in indices)
        types = {n.device_type for n in nodes}
        return ClusterSpec(nodes=nodes,
                           devices={t: self.devices[t] for t in types})

    def node_of_rank(self, rank: int) -> int:
        acc = 0
        for i, n in enumerate(self.nodes):
            acc += n.num_devices
            if rank < acc:
                return i
        raise IndexError(f"rank {rank} out of range ({self.total_devices} devices)")

    # -- per-type properties ----------------------------------------------
    def spec(self, device_type: str) -> DeviceSpec:
        return self.devices[device_type]

    def memory_mb(self, device_type: str) -> float:
        return self.devices[device_type].memory_mb

    def intra_bw_for_type(self, device_type: str) -> float:
        return self.devices[device_type].intra_bw_gbps

    def inter_bw_for_types(
        self, device_types: list[str] | tuple[str, ...], strict_compat: bool = False
    ) -> float:
        """Slowest cross-node bandwidth among member types.

        strict_compat reproduces the reference bug where the inter getter
        reads the intra field (``gpu_cluster.py:56-58``).
        """
        if strict_compat:
            return min(self.devices[t].intra_bw_gbps for t in device_types)
        return min(self.devices[t].inter_bw_gbps for t in device_types)

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_files(hostfile: str | Path, clusterfile: str | Path) -> "ClusterSpec":
        """Parse the reference's two cluster-description files
        (``README.md:194-230``): hostfile lines ``<ip> slots=<n>`` and a JSON
        clusterfile keyed by IP with instance_type/bandwidths/memory."""
        with open(clusterfile) as f:
            info = json.load(f)

        devices: dict[str, DeviceSpec] = {}
        for entry in info.values():
            t = str(entry["instance_type"])
            preset = DEVICE_REGISTRY.get(t)
            devices[t] = DeviceSpec(
                name=t,
                memory_gb=float(entry["memory"]),
                intra_bw_gbps=float(entry["intra_bandwidth"]),
                inter_bw_gbps=float(entry["inter_bandwidth"]),
                hbm_gbps=float(entry.get(
                    "hbm_bandwidth", preset.hbm_gbps if preset else 0.0)),
                tier=str(entry.get(
                    "tier", preset.tier if preset else "reserved")),
                preemption_rate_per_hr=float(entry.get(
                    "preemption_rate_per_hr",
                    preset.preemption_rate_per_hr if preset else 0.0)),
            )

        nodes: list[NodeSpec] = []
        for line in Path(hostfile).read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            m = re.match(r"(\S+)\s+slots\s*=\s*(\d+)", line)
            if not m:
                raise ClusterSpecError(f"bad hostfile line: {line!r}")
            ip, slots = m.group(1), int(m.group(2))
            if ip not in info:
                raise ClusterSpecError(f"hostfile ip {ip} missing from clusterfile")
            nodes.append(NodeSpec(str(info[ip]["instance_type"]), slots))

        return ClusterSpec(nodes=tuple(nodes), devices=devices)

    @staticmethod
    def homogeneous(
        device_type: str, num_nodes: int, devices_per_node: int,
        spec: DeviceSpec | None = None,
    ) -> "ClusterSpec":
        dev = spec or _registry_lookup(device_type)
        return ClusterSpec(
            nodes=tuple(NodeSpec(device_type, devices_per_node) for _ in range(num_nodes)),
            devices={device_type: dev},
        )

    @staticmethod
    def of(*groups: tuple[str, int, int], overrides: dict[str, DeviceSpec] | None = None) -> "ClusterSpec":
        """Build from (device_type, num_nodes, devices_per_node) groups."""
        nodes: list[NodeSpec] = []
        devices: dict[str, DeviceSpec] = {}
        for device_type, num_nodes, per_node in groups:
            nodes.extend(NodeSpec(device_type, per_node) for _ in range(num_nodes))
            if overrides and device_type in overrides:
                devices[device_type] = overrides[device_type]
            else:
                devices[device_type] = _registry_lookup(device_type)
        return ClusterSpec(nodes=tuple(nodes), devices=devices)

    def with_device_spec(self, spec: DeviceSpec) -> "ClusterSpec":
        devices = dict(self.devices)
        devices[spec.name] = spec
        return replace(self, devices=devices)


def _registry_lookup(device_type: str) -> DeviceSpec:
    """Registry access that raises ClusterSpecError, never a bare KeyError —
    search loops prune on KeyError (the ProfileMissError contract), so an
    unregistered device type must not masquerade as a profile miss."""
    try:
        return DEVICE_REGISTRY[device_type]
    except KeyError:
        raise ClusterSpecError(
            f"device type {device_type!r} is not registered; call "
            "register_device() or pass an explicit DeviceSpec") from None
