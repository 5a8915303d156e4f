"""Network topologies for the system-simulation stage (paper §IV-C4).

Three families cover the paper's experiments plus the TPU pod target:

  * AllToAllNode — NVLink-connected GPU node (4 GPUs, paper Fig 6/7);
  * Dragonfly   — hierarchical NVLink-intranode + Slingshot-internode
                  system (16–128 GPUs, paper Fig 8/9);
  * Torus       — TPU ICI 2D/3D torus (TPUv3 slice, v5e pod, multi-pod
                  over DCN).

A topology answers two questions for the collective models:
  - bisection/ring bandwidth available to a group of participants,
  - per-hop latency and hop counts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..registry import register_topology


@dataclass(frozen=True)
class PathProfile:
    """Effective bandwidth/latency seen by a ring (or tree) spanning a group."""
    ring_bw: float          # bytes/s per direction around the ring's slowest link
    latency: float          # per-hop latency, seconds
    hops: int               # hops around the ring
    bidirectional: bool = True


class Topology:
    name: str = "abstract"
    num_devices: int = 0

    def ring(self, group_size: int) -> PathProfile:
        raise NotImplementedError

    def point_to_point(self, size_bytes: float) -> float:
        p = self.ring(2)
        return p.latency + size_bytes / p.ring_bw

    @classmethod
    def from_spec(cls, params: dict, system, context) -> "Topology":
        """Build from a campaign-spec params dict (the registry builder
        protocol — see :mod:`repro_torch.core.registry`).  The default maps
        params straight onto constructor keywords, turning list-valued
        params (JSON arrays, e.g. torus ``dims``) into tuples."""
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in params.items()})


@register_topology("a2a")
@dataclass
class AllToAllNode(Topology):
    """Fully connected NVLink node: every pair has a direct link."""
    num_devices: int = 4
    link_bw: float = 100e9
    link_latency: float = 0.7e-6
    name: str = "nvlink-a2a"

    def ring(self, group_size: int) -> PathProfile:
        g = min(group_size, self.num_devices)
        return PathProfile(ring_bw=self.link_bw, latency=self.link_latency,
                           hops=max(g - 1, 1), bidirectional=True)


@register_topology("dragonfly")
@dataclass
class Dragonfly(Topology):
    """Two-level system: NVLink all-to-all inside a node, dragonfly between
    nodes (paper Fig 8: nodes/router, routers/group, groups)."""
    num_nodes: int = 32
    gpus_per_node: int = 4
    nodes_per_router: int = 4
    routers_per_group: int = 4
    groups: int = 2
    intra_bw: float = 150e9          # NVLink
    inter_bw: float = 25e9           # Slingshot per-node injection
    intra_latency: float = 0.7e-6
    inter_latency: float = 2.0e-6
    name: str = "dragonfly"

    @property
    def num_devices(self) -> int:  # type: ignore[override]
        return self.num_nodes * self.gpus_per_node

    def ring(self, group_size: int) -> PathProfile:
        if group_size <= self.gpus_per_node:
            return PathProfile(ring_bw=self.intra_bw,
                               latency=self.intra_latency,
                               hops=max(group_size - 1, 1))
        # ring spanning nodes: bottleneck is the internode injection bw;
        # average hop latency blends intra (within node) and inter hops
        nodes = math.ceil(group_size / self.gpus_per_node)
        inter_hops = nodes
        intra_hops = max(group_size - nodes, 0)
        total_hops = max(group_size - 1, 1)
        avg_lat = (inter_hops * self.inter_latency
                   + intra_hops * self.intra_latency) / max(
                       inter_hops + intra_hops, 1)
        return PathProfile(ring_bw=self.inter_bw, latency=avg_lat,
                           hops=total_hops)

    def hierarchical_levels(self, group_size: int) -> list[tuple[int, "PathProfile"]]:
        """(participants, profile) per level for hierarchical collectives."""
        levels = []
        intra = min(group_size, self.gpus_per_node)
        if intra > 1:
            levels.append((intra, PathProfile(
                ring_bw=self.intra_bw, latency=self.intra_latency,
                hops=intra - 1)))
        nodes = math.ceil(group_size / self.gpus_per_node)
        if nodes > 1:
            levels.append((nodes, PathProfile(
                ring_bw=self.inter_bw, latency=self.inter_latency,
                hops=nodes)))
        return levels


@register_topology("torus")
@dataclass
class Torus(Topology):
    """TPU ICI torus.  dims=(16,16) is a v5e pod; wrap links double ring bw.

    A ring mapped along one torus axis uses that axis's wrap ring; a group
    larger than one axis snakes over multiple axes (still a hamiltonian
    ring on a torus — every hop is a physical link)."""
    dims: tuple[int, ...] = (16, 16)
    link_bw: float = 50e9
    link_latency: float = 1.0e-6
    name: str = "ici-torus"

    @property
    def num_devices(self) -> int:  # type: ignore[override]
        return math.prod(self.dims)

    def ring(self, group_size: int) -> PathProfile:
        return PathProfile(ring_bw=self.link_bw, latency=self.link_latency,
                           hops=max(group_size - 1, 1), bidirectional=True)

    def axis_rings(self, group_size: int) -> int:
        """Independent bidirectional rings usable by one collective.

        On a torus, a collective along a mesh axis can stripe payload over
        both directions; with wraparound links each participant has 2 links
        per axis, so an axis-aligned ring sustains 2×link_bw."""
        return 2


@register_topology("multipod")
@dataclass
class MultiPod(Topology):
    """Pods of ``pod_topology`` connected by a data-center network (DCN)."""
    pod: Torus = field(default_factory=Torus)
    num_pods: int = 2
    dcn_bw_per_host: float = 12.5e9   # 100 Gb/s NIC
    hosts_per_pod: int = 64           # v5e: 4 chips/host
    dcn_latency: float = 10e-6
    name: str = "multipod"

    @property
    def num_devices(self) -> int:  # type: ignore[override]
        return self.pod.num_devices * self.num_pods

    def ring(self, group_size: int) -> PathProfile:
        if group_size <= self.pod.num_devices:
            return self.pod.ring(group_size)
        # cross-pod ring: DCN is the bottleneck, but all hosts inject in
        # parallel — aggregate DCN bw divided by participating chips
        chips_per_pod = self.pod.num_devices
        agg_dcn = self.dcn_bw_per_host * self.hosts_per_pod
        per_chip = agg_dcn / chips_per_pod
        return PathProfile(ring_bw=per_chip, latency=self.dcn_latency,
                           hops=self.num_pods, bidirectional=True)

    def hierarchical_levels(self, group_size: int) -> list[tuple[int, PathProfile]]:
        levels = []
        intra = min(group_size, self.pod.num_devices)
        if intra > 1:
            levels.append((intra, self.pod.ring(intra)))
        pods = math.ceil(group_size / self.pod.num_devices)
        if pods > 1:
            chips_per_pod = self.pod.num_devices
            agg = self.dcn_bw_per_host * self.hosts_per_pod
            levels.append((pods, PathProfile(
                ring_bw=agg / chips_per_pod, latency=self.dcn_latency,
                hops=pods)))
        return levels

    @classmethod
    def from_spec(cls, params: dict, system, context) -> "MultiPod":
        """Spec form: the nested ``pod`` params dict builds the Torus."""
        p = dict(params)
        pod = p.pop("pod", None)
        if pod is not None:
            p["pod"] = Torus.from_spec(dict(pod), system, context)
        return cls(**p)


@register_topology("auto")
class AutoTopology:
    """Derive the topology family from the grid system's interconnect
    record — the cross-architecture axis: one grid, per-system native
    fabric (all-to-all node for GPUs, torus for TPUs).

    Not a topology itself: ``from_spec`` *returns* the derived
    :class:`AllToAllNode`/:class:`Torus`.  Only num_devices/link_bw come
    from the system so the numbers match a hand-built topology with
    class defaults."""

    @classmethod
    def from_spec(cls, params: dict, system, context) -> Topology:
        ic = system.interconnect
        n = int(params.get("num_devices", 4))
        if ic.kind in ("torus2d", "torus3d"):
            dims = tuple(ic.params.get("dims", (2, 2)))
            if "num_devices" in params and n != math.prod(dims):
                # a torus fabric is fixed by the system's dims; silently
                # simulating a different device count than requested
                # would corrupt the cross-architecture comparison
                raise ValueError(
                    f"topology 'auto' on system {system.name!r}: requested "
                    f"num_devices={n} but the system's "
                    f"{ic.kind} interconnect has dims={dims} "
                    f"({math.prod(dims)} devices) — drop num_devices to "
                    "use the system fabric, or use an explicit 'torus' "
                    "topology with your own dims")
            return Torus(dims=dims, link_bw=ic.link_bw)
        return AllToAllNode(num_devices=n, link_bw=ic.link_bw)
