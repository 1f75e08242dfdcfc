"""Tiered-interconnect topology builders — non-uniform ``Platform`` factories.

Port of ``repro/platforms/topology.py`` by copy (numpy): each builder and
``device_feature_table`` give the reference's arrays bit for bit.

The paper's host is a flat 2-device box; real fleets are not.  This module
describes a fleet as a :class:`Topology` — devices, a small set of link
*tiers* (NVLink / PCIe / NIC / per-hop mesh links, each with its own
bandwidth and latency), a (D, D) tier assignment, and per-device
coordinates — and lowers it to a :class:`~repro_torch.core.costmodel.Platform`
with genuinely non-uniform link matrices.

Builders
--------
``nvlink_island``   islands of NVLink-connected GPUs bridged by PCIe
``multi_host``      hosts of PCIe-attached GPUs (NVLink pairs) over a NIC
``torus``           2-D wraparound mesh; multi-hop links degrade per hop
``ring``            1-D wraparound mesh (a 1×N torus with spoke coords)

:func:`device_feature_table` exports the fleet as a ``(D, F_DEV)`` float
table (fleet-normalized flops / mem-bw / capacity / dispatch / queue count,
link statistics, coordinates) — the conditioning input of the
``head="device"`` policy, whose fixed width ``F_DEV`` is what lets one set
of policy parameters score placements on fleets of any size or shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from ..core.costmodel import DeviceSpec, Platform

__all__ = [
    "LinkTier", "Topology", "nvlink_island", "multi_host", "torus", "ring",
    "device_feature_table", "DEV_FEATURE_DIM",
]

#: Width of :func:`device_feature_table` rows.  Fixed across fleets — the
#: device-embedding MLP of the ``head="device"`` policy is shaped by it.
DEV_FEATURE_DIM = 12

#: Max coordinate columns folded into the feature table (extra axes are
#: dropped; missing axes are zero-padded).
_COORD_DIMS = 3


@dataclasses.dataclass(frozen=True)
class LinkTier:
    """One interconnect class: a name plus its bandwidth/latency."""

    name: str
    bandwidth: float        # bytes/s, > 0 finite
    latency: float          # seconds, >= 0 finite

    def __post_init__(self):
        if not (math.isfinite(self.bandwidth) and self.bandwidth > 0):
            raise ValueError(f"LinkTier {self.name!r}: bandwidth must be "
                             f"positive finite, got {self.bandwidth!r}")
        if not (math.isfinite(self.latency) and self.latency >= 0):
            raise ValueError(f"LinkTier {self.name!r}: latency must be "
                             f"non-negative finite, got {self.latency!r}")


@dataclasses.dataclass(frozen=True)
class Topology:
    """A fleet description: devices + tiered links + coordinates.

    ``tier_index[i, j]`` names the :class:`LinkTier` carrying i→j traffic
    (diagonal entries are ignored — a device never pays transfer to
    itself).  :meth:`to_platform` lowers the description to a cost-model
    :class:`Platform` whose ``link_bw`` / ``link_latency`` matrices are the
    per-pair tier constants, and whose ``coords`` carry the device
    coordinates onward to :func:`device_feature_table`.
    """

    devices: Tuple[DeviceSpec, ...]
    tiers: Tuple[LinkTier, ...]
    tier_index: np.ndarray   # (D, D) int — tier of each ordered pair
    coords: np.ndarray       # (D, C) float — island/row/col/spoke positions

    def __post_init__(self):
        d = len(self.devices)
        ti = np.asarray(self.tier_index)
        if ti.shape != (d, d):
            raise ValueError(f"Topology.tier_index must be ({d}, {d}); "
                             f"got {ti.shape}")
        off = ~np.eye(d, dtype=bool)
        bad = np.argwhere(off & ((ti < 0) | (ti >= len(self.tiers))))
        if bad.size:
            i, j = (int(x) for x in bad[0])
            raise ValueError(
                f"Topology.tier_index[{i}, {j}] = {ti[i, j]} out of range "
                f"for {len(self.tiers)} tiers")
        c = np.asarray(self.coords)
        if c.ndim != 2 or c.shape[0] != d:
            raise ValueError(f"Topology.coords must be ({d}, C); "
                             f"got {c.shape}")

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def to_platform(self) -> Platform:
        d = self.num_devices
        bw = np.array([t.bandwidth for t in self.tiers])
        lat = np.array([t.latency for t in self.tiers])
        ti = np.asarray(self.tier_index)
        safe = np.where(np.eye(d, dtype=bool), 0, ti)
        link_bw = bw[safe]
        link_lat = lat[safe]
        np.fill_diagonal(link_bw, math.inf)
        np.fill_diagonal(link_lat, 0.0)
        return Platform(self.devices, link_bw, link_lat,
                        coords=np.asarray(self.coords, dtype=np.float64))


def _gpu(name: str, *, peak_flops: float, mem_bw: float, mem_capacity: float,
         parallel_queues: int) -> DeviceSpec:
    return DeviceSpec(
        name, "gpu", peak_flops=peak_flops, mem_bw=mem_bw,
        dispatch_overhead=4e-6, mem_capacity=mem_capacity,
        efficiency=(("conv", 0.30), ("gemm", 0.70), ("eltwise", 1.0)),
        parallel_queues=parallel_queues)


def _positive_int(name: str, v, lo: int = 1) -> int:
    v = int(v)
    if v < lo:
        raise ValueError(f"{name} must be >= {lo}, got {v}")
    return v


def nvlink_island(islands: int = 2, gpus_per_island: int = 4, *,
                  peak_flops: float = 16e12, mem_bw: float = 560e9,
                  mem_capacity: float = 16e9,
                  island_scale: float = 1.0,
                  nvlink_bw: float = 300e9, nvlink_lat: float = 1e-6,
                  pcie_bw: float = 25e9, pcie_lat: float = 5e-6,
                  parallel_queues: int = 1) -> Platform:
    """Islands of NVLink-connected GPUs, bridged island-to-island by PCIe.

    ``island_scale`` < 1 makes the fleet heterogeneous: island *i*'s GPUs
    run at ``island_scale**i`` of the base flops/mem-bw/capacity (an
    older-generation pool behind the same fabric).
    """
    islands = _positive_int("islands", islands)
    gpus_per_island = _positive_int("gpus_per_island", gpus_per_island)
    if not (0 < island_scale <= 1.0):
        raise ValueError(f"island_scale must be in (0, 1], got {island_scale}")
    devices, coords = [], []
    for i in range(islands):
        s = island_scale ** i
        for g in range(gpus_per_island):
            devices.append(_gpu(f"isl{i}/gpu{g}",
                                peak_flops=peak_flops * s, mem_bw=mem_bw * s,
                                mem_capacity=mem_capacity * s,
                                parallel_queues=parallel_queues))
            coords.append((i, g))
    d = len(devices)
    island_of = np.asarray([c[0] for c in coords])
    tier_index = np.where(island_of[:, None] == island_of[None, :], 0, 1)
    topo = Topology(
        devices=tuple(devices),
        tiers=(LinkTier("nvlink", nvlink_bw, nvlink_lat),
               LinkTier("pcie", pcie_bw, pcie_lat)),
        tier_index=tier_index,
        coords=np.asarray(coords, dtype=np.float64))
    return topo.to_platform()


def multi_host(hosts: int = 2, gpus_per_host: int = 4, *,
               peak_flops: float = 16e12, mem_bw: float = 560e9,
               mem_capacity: float = 16e9,
               nvlink_bw: float = 300e9, nvlink_lat: float = 1e-6,
               pcie_bw: float = 25e9, pcie_lat: float = 5e-6,
               nic_bw: float = 12.5e9, nic_lat: float = 20e-6,
               parallel_queues: int = 1) -> Platform:
    """Hosts of PCIe-attached GPUs over a NIC; adjacent same-host GPU pairs
    share an NVLink bridge (the common 2-way-bridge workstation layout).
    Three tiers: NVLink (paired), PCIe (same host), NIC (cross-host)."""
    hosts = _positive_int("hosts", hosts)
    gpus_per_host = _positive_int("gpus_per_host", gpus_per_host)
    devices, coords = [], []
    for h in range(hosts):
        for g in range(gpus_per_host):
            devices.append(_gpu(f"host{h}/gpu{g}",
                                peak_flops=peak_flops, mem_bw=mem_bw,
                                mem_capacity=mem_capacity,
                                parallel_queues=parallel_queues))
            coords.append((h, g))
    d = len(devices)
    host_of = np.asarray([c[0] for c in coords])
    pair_of = np.asarray([(c[0], c[1] // 2) for c in coords])
    same_host = host_of[:, None] == host_of[None, :]
    same_pair = same_host & (pair_of[:, None, 1] == pair_of[None, :, 1])
    tier_index = np.where(same_pair, 0, np.where(same_host, 1, 2))
    topo = Topology(
        devices=tuple(devices),
        tiers=(LinkTier("nvlink", nvlink_bw, nvlink_lat),
               LinkTier("pcie", pcie_bw, pcie_lat),
               LinkTier("nic", nic_bw, nic_lat)),
        tier_index=tier_index,
        coords=np.asarray(coords, dtype=np.float64))
    return topo.to_platform()


def _hop_tiers(max_hops: int, link_bw: float, link_lat: float
               ) -> Tuple[LinkTier, ...]:
    # Multi-hop traffic shares per-hop links: bandwidth divides by the hop
    # count, latency accumulates per hop — the standard store-and-forward
    # mesh approximation.
    return tuple(LinkTier(f"hop{k}", link_bw / k, link_lat * k)
                 for k in range(1, max_hops + 1))


def torus(rows: int = 2, cols: int = 4, *,
          peak_flops: float = 197e12, mem_bw: float = 819e9,
          mem_capacity: float = 16e9,
          link_bw: float = 50e9, link_lat: float = 2e-6,
          parallel_queues: int = 1) -> Platform:
    """2-D wraparound mesh of accelerator chips (TPU-style ICI fabric).

    Neighbors talk at full per-link bandwidth; (i, j) pairs further apart
    pay the torus Manhattan distance in divided bandwidth and accumulated
    latency.  Coordinates are (row, col)."""
    rows = _positive_int("rows", rows)
    cols = _positive_int("cols", cols)
    coords = [(r, c) for r in range(rows) for c in range(cols)]
    devices = tuple(
        DeviceSpec(f"chip{r}_{c}", "tpu-stage", peak_flops=peak_flops,
                   mem_bw=mem_bw, dispatch_overhead=2e-6,
                   mem_capacity=mem_capacity,
                   parallel_queues=parallel_queues)
        for r, c in coords)
    d = len(devices)
    rr = np.asarray([c[0] for c in coords])
    cc = np.asarray([c[1] for c in coords])
    dr = np.abs(rr[:, None] - rr[None, :])
    dc = np.abs(cc[:, None] - cc[None, :])
    hops = np.minimum(dr, rows - dr) + np.minimum(dc, cols - dc)
    max_hops = max(1, int(hops.max()))
    tier_index = np.maximum(hops, 1) - 1      # diagonal ignored anyway
    topo = Topology(
        devices=devices,
        tiers=_hop_tiers(max_hops, link_bw, link_lat),
        tier_index=tier_index,
        coords=np.asarray(coords, dtype=np.float64))
    return topo.to_platform()


def ring(devices: int = 4, *,
         peak_flops: float = 197e12, mem_bw: float = 819e9,
         mem_capacity: float = 16e9,
         link_bw: float = 50e9, link_lat: float = 2e-6,
         parallel_queues: int = 1) -> Platform:
    """1-D wraparound mesh; coordinates are the spoke index."""
    n = _positive_int("devices", devices)
    specs = tuple(
        DeviceSpec(f"chip{i}", "tpu-stage", peak_flops=peak_flops,
                   mem_bw=mem_bw, dispatch_overhead=2e-6,
                   mem_capacity=mem_capacity,
                   parallel_queues=parallel_queues)
        for i in range(n))
    idx = np.arange(n)
    dist = np.abs(idx[:, None] - idx[None, :])
    hops = np.minimum(dist, n - dist)
    max_hops = max(1, int(hops.max()))
    tier_index = np.maximum(hops, 1) - 1
    topo = Topology(
        devices=specs,
        tiers=_hop_tiers(max_hops, link_bw, link_lat),
        tier_index=tier_index,
        coords=idx[:, None].astype(np.float64))
    return topo.to_platform()


def device_feature_table(platform: Platform) -> np.ndarray:
    """Fleet → ``(D, DEV_FEATURE_DIM)`` f32 conditioning table.

    Columns (all fleet-normalized to [0, 1] so the same policy weights
    transfer across fleets of different absolute scale):

    ======  ====================================================
    0       peak_flops / fleet max
    1       mem_bw / fleet max
    2       mem_capacity / fleet max finite capacity (inf → 1)
    3       dispatch_overhead / fleet max
    4       parallel_queues / fleet max
    5       mean outgoing off-diagonal link bandwidth / fleet max
    6       max outgoing off-diagonal link bandwidth / fleet max
    7       mean outgoing off-diagonal link latency / fleet max
    8       is-accelerator flag (kind != "cpu")
    9..11   device coordinates, min-max normalized per axis
            (zero-padded / truncated to 3 axes)
    ======  ====================================================
    """
    devs = platform.devices
    d = len(devs)

    def norm(vals):
        vals = np.asarray(vals, np.float64)
        m = vals.max()
        return vals / m if m > 0 else np.zeros_like(vals)

    caps = np.asarray([dv.mem_capacity for dv in devs], np.float64)
    finite = caps[np.isfinite(caps)]
    cap_ref = finite.max() if finite.size else 1.0
    cap_col = np.where(np.isfinite(caps),
                       caps / cap_ref if cap_ref > 0 else 0.0, 1.0)

    off = ~np.eye(d, dtype=bool)
    bw = np.asarray(platform.link_bw, np.float64)
    lat = np.asarray(platform.link_latency, np.float64)
    if d > 1:
        out_bw = np.where(off, bw, 0.0)
        mean_bw = out_bw.sum(1) / (d - 1)
        max_bw = out_bw.max(1)
        mean_lat = np.where(off, lat, 0.0).sum(1) / (d - 1)
    else:
        mean_bw = max_bw = mean_lat = np.zeros(d)

    coords = platform.coords
    coord_cols = np.zeros((d, _COORD_DIMS))
    if coords is not None:
        c = np.asarray(coords, np.float64)[:, :_COORD_DIMS]
        span = c.max(0) - c.min(0)
        span = np.where(span > 0, span, 1.0)
        coord_cols[:, :c.shape[1]] = (c - c.min(0)) / span

    table = np.column_stack([
        norm([dv.peak_flops for dv in devs]),
        norm([dv.mem_bw for dv in devs]),
        cap_col,
        norm([dv.dispatch_overhead for dv in devs]),
        norm([max(1, dv.parallel_queues) for dv in devs]),
        norm(mean_bw),
        norm(max_bw),
        norm(mean_lat),
        np.asarray([0.0 if dv.kind == "cpu" else 1.0 for dv in devs]),
        coord_cols,
    ]).astype(np.float32)
    assert table.shape == (d, DEV_FEATURE_DIM), table.shape
    return table
