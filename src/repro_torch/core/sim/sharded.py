"""ShardedRolloutEngine — the (G, B) window rollout tiled over a 2-D mesh.

Port of ``repro/core/sim/sharded.py``.  A ("graphs", "chains") mesh tiles
the corpus trainer's chain grid: graph slots along one axis, REINFORCE
chains along the other.  The reference ``shard_map``s its window functions
over the mesh from one process; here every rank runs the same trainer (as
under ``torchrun``) and owns one tile, graph slots
``[gi·G/gm, (gi+1)·G/gm)`` and chains ``[bi·B/bm, (bi+1)·B/bm)``:

* **rollout** is local to the tile: one
  :class:`~repro_torch.core.sim.rollout.RolloutEngine` for each of the
  rank's graphs, each chain drawing from its own stream of global (slot,
  chain) ids.  The window's placements (padded to the episode's largest
  graph), group counts, rewards and latencies are then all-gathered, so
  every rank holds the whole (T, G, B) window, as ``shard_map``'s global
  outputs: the best tracker, the sampler and the population controller run
  unchanged and agree on every rank.  Each rank scores only its tile
  (:meth:`ShardedRolloutEngine.tile_pipeline`).
* **gradients**: each rank's loss is its tile's Eq.-14 loss over the
  *global* chain count G·B, summed over the mesh by one all-reduce, so one
  optimizer step consumes the unsharded mean gradient and the replicated
  parameters stay equal on every rank.
* **reward standardization** can run in-mesh too (:meth:`window_weights`,
  the corpus trainer's ``update="fused"``): per-graph moments all-reduce
  over the "chains" axis only, graphs never mix, matching the host math in
  float32.  By default the trainer takes the host's float64 weights from
  the gathered rewards, which every rank already holds.

Without a process group only the 1×1 mesh exists (:class:`LocalMesh`) and
every collective is the identity, so a 1×1 run is the unsharded
:class:`~repro_torch.core.sim.rollout.MultiRolloutEngine` run bit for bit.
Under a group every collective runs, on the card over NCCL; a group of one
rank computes the same.  Meshes of several ranks run under ``torchrun
--nproc-per-node=gm·bm`` (or on the CPU over gloo).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ...distributed.sharding import ROLLOUT_RULES, logical_spec
from ..train import population as popmod
from .rollout import (MultiRolloutEngine, WindowRecord, pad_placements,
                      policy_grads)

__all__ = ["ShardedRolloutEngine", "make_rollout_mesh", "LocalMesh",
           "rollout_tile"]

_AXES = ("graphs", "chains")
#: the process-group backend of each device type
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


class LocalMesh:
    """The 1×1 ("graphs", "chains") mesh of a process with no process
    group: the DeviceMesh surface the engine reads, with no groups."""

    mesh_dim_names = _AXES
    shape = (1, 1)

    def __init__(self, device_type: str = "cpu"):
        self.device_type = device_type

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    def get_coordinate(self) -> List[int]:
        return [0, 0]

    def get_group(self, mesh_dim=None):
        return None


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_rollout_mesh(graph_shards: int, chain_shards: int,
                      device_type: Optional[str] = None):
    """A ``graph_shards × chain_shards`` mesh named ("graphs", "chains").

    It never starts a process group: under one (``init_process_group``,
    e.g. from ``torchrun``) its world size must be ``graph_shards ·
    chain_shards`` and the mesh is ``init_device_mesh(device_type, ...)``,
    rank r at coordinate (r // chain_shards, r % chain_shards); without one
    only the 1×1 mesh exists (a :class:`LocalMesh`).  ``device_type``
    (default: the group backend's) is "cuda" over NCCL, where rank r's
    device becomes ``cuda:<LOCAL_RANK>``, or "cpu" over gloo.
    """
    gs, bs = int(graph_shards), int(chain_shards)
    if gs < 1 or bs < 1:
        raise ValueError(f"mesh shape must be positive, got ({gs}, {bs})")
    need = gs * bs
    world = dist.get_world_size() if _grouped() else 1
    if need != world:
        running = (f"the process group has {world}" if _grouped() else
                   "no process group is initialized (one process)")
        raise ValueError(
            f"mesh ({gs}, {bs}) needs {need} processes but {running} — "
            f"launch it with torchrun --nproc-per-node={need} and call "
            f"torch.distributed.init_process_group before the mesh is "
            f"built")
    if not _grouped():
        return LocalMesh(device_type or "cpu")
    backend = str(dist.get_backend())
    if device_type is None:
        device_type = "cuda" if "nccl" in backend else "cpu"
    if device_type not in _BACKEND or _BACKEND[device_type] not in backend:
        raise ValueError(
            f"a {device_type} rollout mesh needs a "
            f"{_BACKEND.get(device_type, '?')} process group, got backend "
            f"{backend!r}")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (gs, bs), mesh_dim_names=_AXES)


def _check_tiling(gm: int, bm: int, G: int, B: Optional[int] = None):
    if G % gm:
        raise ValueError(
            f"graph batch G={G} does not tile the mesh 'graphs' axis "
            f"({gm}) — pick graphs_per_episode divisible by it")
    if B is not None and B % bm:
        raise ValueError(
            f"chain batch B={B} does not tile the mesh 'chains' axis "
            f"({bm}) — pick batch_chains divisible by it")


def _mesh_axes(mesh) -> Tuple[int, int, int, int]:
    """(gm, bm, gi, bi): the mesh's "graphs" and "chains" extents and this
    rank's coordinates on them, found through :data:`ROLLOUT_RULES`."""
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in _AXES if a not in names]
    if missing:
        raise ValueError(
            f"rollout mesh must carry axes {_AXES}, got {names} (missing "
            f"{missing})")
    _, g_axis, b_axis = logical_spec(("time", "graphs", "chains"),
                                     ROLLOUT_RULES, mesh)
    gd, bd = names.index(g_axis), names.index(b_axis)
    coord = mesh.get_coordinate()
    return mesh.size(gd), mesh.size(bd), coord[gd], coord[bd]


def rollout_tile(mesh, num_graphs: int,
                 num_chains: Optional[int] = None) -> Tuple[slice, slice]:
    """This rank's (graph slots, chains) of a (G, B) grid on ``mesh``."""
    gm, bm, gi, bi = _mesh_axes(mesh)
    _check_tiling(gm, bm, num_graphs, num_chains)
    gl = num_graphs // gm
    chains = slice(None) if num_chains is None else \
        slice(bi * (num_chains // bm), (bi + 1) * (num_chains // bm))
    return slice(gi * gl, (gi + 1) * gl), chains


class ShardedRolloutEngine:
    """A :class:`~repro_torch.core.sim.rollout.MultiRolloutEngine` whose
    (G, B) grid is tiled over ``mesh`` (see module docstring).

    ``mesh`` is a :func:`make_rollout_mesh`; ``engines`` are the
    :class:`RolloutEngine` of this rank's graph slots (``rollout_tile``);
    ``num_nodes`` is the node count of every slot of
    the grid, all G of them.  State — ``zs``, window records, the population
    — is this rank's tile; window outputs (placements, group counts,
    rewards, latencies, replay weights) are the whole grid's.  The grid
    must tile the mesh: G divisible by the "graphs" extent, B by the
    "chains" extent (checked with the sizes named).
    """

    def __init__(self, engines: Sequence, *, num_nodes: Sequence[int], mesh,
                 population=None):
        self.mesh = mesh
        self._gm, self._bm, self._gi, self._bi = _mesh_axes(mesh)
        self._grouped = not isinstance(mesh, LocalMesh)
        self._graphs_group = mesh.get_group("graphs")
        self._chains_group = mesh.get_group("chains")
        self.num_nodes = [int(n) for n in num_nodes]
        self._gsl, _ = rollout_tile(mesh, len(self.num_nodes))
        if len(engines) != len(self.num_nodes) // self._gm:
            raise ValueError(
                f"{len(engines)} rollout engines for a tile of "
                f"{len(self.num_nodes) // self._gm} graph slots")
        self._local = MultiRolloutEngine(engines, population=population)
        self.engines = self._local.engines
        self.policy = self._local.policy
        self.population = population
        self._device = self.engines[0].x0.device

    @property
    def num_graphs(self) -> int:
        """G, the whole grid's graph slots."""
        return len(self.num_nodes)

    def _chains(self, num_local: int) -> slice:
        return slice(self._bi * num_local, (self._bi + 1) * num_local)

    # ------------------------------------------------------ collectives
    def _gather_grid(self, t: torch.Tensor, gdim: int) -> torch.Tensor:
        """``t`` of shape pre + (G_l, B_l) + post on each rank (its graph
        dim at ``gdim``) → pre + (G, B) + post on every rank."""
        if not self._grouped:
            return t
        gm, bm = self._gm, self._bm
        flat = t.new_empty(gm * bm * t.numel())
        dist.all_gather_into_tensor(flat, t.contiguous().reshape(-1))
        full = flat.view((gm, bm) + tuple(t.shape))
        # (gm, bm, *pre, G_l, B_l, *post) → (*pre, gm, G_l, bm, B_l, *post)
        p = gdim
        perm = (list(range(2, 2 + p)) + [0, 2 + p, 1, 3 + p]
                + list(range(4 + p, full.dim())))
        shape = (t.shape[:p] + (gm * t.shape[p], bm * t.shape[p + 1])
                 + t.shape[p + 2:])
        return full.permute(perm).reshape(shape)

    def _gather_group(self, t: torch.Tensor, group, size: int,
                      dim: int) -> torch.Tensor:
        """``t`` gathered over ``group`` (``size`` ranks, in coordinate
        order) and concatenated along ``dim``."""
        if not self._grouped:
            return t
        flat = t.new_empty(size * t.numel())
        dist.all_gather_into_tensor(flat, t.contiguous().reshape(-1),
                                    group=group)
        return torch.cat(flat.view((size,) + tuple(t.shape)).unbind(0),
                         dim=dim)

    def _sum(self, tensors: Sequence[torch.Tensor], group) -> List:
        """Each tensor summed over ``group`` (None: the whole mesh), in one
        all-reduce of their concatenation."""
        if not self._grouped:
            return list(tensors)
        flat = torch.cat([x.reshape(-1) for x in tensors])
        dist.all_reduce(flat, group=group)
        out, off = [], 0
        for x in tensors:
            out.append(flat[off:off + x.numel()].view(x.shape))
            off += x.numel()
        return out

    def _gather_fines(self, fines: Sequence[torch.Tensor]) -> List:
        """This tile's G_l × (T, B_l, V_g) placements → the grid's
        G × (T, B, V_g), gathered padded to the largest graph."""
        full = self._gather_grid(pad_placements(fines, max(self.num_nodes)),
                                 1)
        return [full[:, g, :, :v] for g, v in enumerate(self.num_nodes)]

    # -------------------------------------------------------- window API
    def initial_state(self, num_chains: int) -> List[torch.Tensor]:
        """This tile's chains at their graphs' initial features →
        G_l (B_l, V_g, d); ``num_chains`` is the grid's B."""
        _check_tiling(self._gm, self._bm, self.num_graphs, num_chains)
        return self._local.initial_state(num_chains // self._bm)

    def rollout_window(self, zs: Sequence[torch.Tensor], *, num_steps: int,
                       start_first: bool, streams=None, noise=None,
                       temperature: Optional[torch.Tensor] = None):
        """Sample a window of this tile's chains (``zs``, ``streams`` or
        ``noise`` and ``temperature`` are the tile's) → (the tile's zs and
        records, the grid's placements G × (T, B, V_g) and group counts
        (T, G, B))."""
        zs, records, fines, ngroups = self._local.rollout_window(
            zs, num_steps=num_steps, start_first=start_first,
            streams=streams, noise=noise, temperature=temperature)
        return (zs, records, self._gather_fines(fines),
                self._gather_grid(ngroups, 1))

    def tile_pipeline(self, pipeline) -> "TilePipeline":
        """``pipeline`` (a ``RewardPipeline`` over this tile's graphs) as a
        scorer of the grid's windows: it scores this tile, then gathers."""
        return TilePipeline(pipeline, self)

    def pad(self, fines: Sequence[torch.Tensor],
            width: Optional[int] = None) -> torch.Tensor:
        """The grid's G × (T, B, V_g) placements → (T, G, B, width), zero at
        pads; ``width`` defaults to the largest graph."""
        return pad_placements(
            fines, max(self.num_nodes) if width is None else int(width))

    def window_grads(self, zs: Sequence[torch.Tensor],
                     records: Sequence[WindowRecord], weights: torch.Tensor,
                     *, start_first: bool,
                     rederive: bool = False) -> List[torch.Tensor]:
        """∇θ of the Eq.-14 loss over the whole grid's window, averaged over
        its G·B chains: this tile's loss over G·B, summed over the mesh.
        ``zs`` and ``records`` are the tile's, ``weights`` the grid's
        (T, G, B)."""
        bl = zs[0].shape[0]
        _check_tiling(self._gm, self._bm, weights.shape[1], weights.shape[2])
        w = weights[:, self._gsl, self._chains(bl)]
        total = self._local.window_loss(zs, records, w,
                                        start_first=start_first,
                                        rederive=rederive)
        grads = policy_grads(self.policy,
                             total / (self.num_graphs * bl * self._bm))
        return self._sum(grads, None)

    def window_weights(self, rewards: torch.Tensor, *, gamma: float,
                       reward_to_go: bool, normalize: bool,
                       reward_norm: str) -> torch.Tensor:
        """The grid's (T, G, B) rewards → its (T, G, B) Eq.-14 replay
        weights, float32: the corpus trainer's per-graph standardization
        (moments summed over the "chains" axis), the discounting and the
        per-chain normalization over T, each on this rank's tile, then
        gathered.  A float32 mirror of the host's float64
        ``loop.window_weights``."""
        rewards = torch.as_tensor(rewards, dtype=torch.float32,
                                  device=self._device)
        T, G, B = rewards.shape
        _check_tiling(self._gm, self._bm, G, B)
        r = rewards[:, self._gsl, self._chains(B // self._bm)]
        if reward_norm == "pergraph":
            cnt = float(T * B)
            s, = self._sum([r.sum(dim=(0, 2), keepdim=True)],
                           self._chains_group)
            mean = s / cnt
            v, = self._sum([((r - mean) ** 2).sum(dim=(0, 2), keepdim=True)],
                           self._chains_group)
            r = (r - mean) / (torch.sqrt(v / cnt) + 1e-8)
        if reward_to_go:
            acc = torch.zeros_like(r[0])
            steps = []
            for t in range(T - 1, -1, -1):
                acc = r[t] + gamma * acc
                steps.append(acc)
            w = torch.stack(steps[::-1])
        else:
            disc = gamma ** torch.arange(T, dtype=torch.float32,
                                         device=r.device)
            w = disc[:, None, None] * r
        if normalize and T > 1:
            std = w.std(dim=0, correction=0, keepdim=True)
            safe = torch.where(std > 1e-12, std, torch.ones_like(std))
            w = torch.where(std > 1e-12,
                            (w - w.mean(dim=0, keepdim=True)) / safe, w)
        return self._gather_grid(w, 1)

    def greedy_decode(self, num_real: Optional[int] = None
                      ) -> List[torch.Tensor]:
        """One greedy decode of the grid's first ``num_real`` slots (default:
        all; the rest pad a short batch to the mesh and are not decoded) →
        G × (V_g,), zero for a pad slot: each rank decodes its tile's,
        gathered over "graphs"."""
        real = self.num_graphs if num_real is None else int(num_real)
        n = min(len(self.engines), max(0, real - self._gsl.start))
        local = MultiRolloutEngine(self.engines[:n]).greedy_decode() \
            if n else []
        padded = torch.zeros(len(self.engines), max(self.num_nodes),
                             dtype=torch.long, device=self._device)
        for g, p in enumerate(local):
            padded[g, :p.shape[0]] = p
        full = self._gather_group(padded, self._graphs_group, self._gm, 0)
        return [full[g, :v] for g, v in enumerate(self.num_nodes)]

    # ------------------------------------------------------- population API
    def init_population(self, generator: torch.Generator, *,
                        num_chains: int, temperatures=None,
                        num_nodes: Optional[int] = None
                        ) -> popmod.ChainState:
        """This tile of the grid's fresh (G, B) population state: every
        rank draws the whole grid's from ``generator`` (the same on every
        rank) and keeps its tile.  Best placements are padded to
        ``num_nodes`` (default: the largest graph)."""
        _check_tiling(self._gm, self._bm, self.num_graphs, num_chains)
        pop = popmod.init_chain_state(
            self._local._population_cfg(), generator,
            num_graphs=self.num_graphs, num_chains=num_chains,
            num_nodes=max(self.num_nodes) if num_nodes is None
            else num_nodes, temperatures=temperatures)
        bsl = self._chains(num_chains // self._bm)
        return pop._replace(
            temperature=pop.temperature[self._gsl, bsl].clone(),
            best_latency=pop.best_latency[self._gsl, bsl].clone(),
            best_fine=pop.best_fine[self._gsl, bsl].clone())

    def update_population(self, pop: popmod.ChainState, fines: torch.Tensor,
                          latencies) -> popmod.ChainState:
        """Fold the grid's window — (T, G, B, V) placements and (T, G, B)
        latencies — into this tile's chain-best records."""
        lat = torch.as_tensor(np.asarray(latencies), dtype=torch.float32,
                              device=fines.device)
        bsl = self._chains(pop.temperature.shape[1])
        return popmod.update_chain_bests(pop, fines[:, self._gsl, bsl],
                                         lat[:, self._gsl, bsl])

    def gather_population(self, pop: popmod.ChainState) -> popmod.ChainState:
        """This tile's population state → the grid's, on every rank."""
        return pop._replace(
            temperature=self._gather_grid(pop.temperature, 0),
            best_latency=self._gather_grid(pop.best_latency, 0),
            best_fine=self._gather_grid(pop.best_fine, 0))

    def pbt_step(self, pop: popmod.ChainState, zs: Sequence[torch.Tensor],
                 *, use_greedy: bool = False,
                 draws: Optional[popmod.PBTDraws] = None):
        """One PBT round over this tile's rows → (pop, zs), the tile's.

        Each rank gathers its rows' best latencies and temperatures over
        "chains", draws the whole grid's (G, B) block from ``pop.rng``
        (``draws`` replaces it), so every rank takes the same decisions,
        and keeps its columns.  The row's best chain's state and record
        come from one-hot partial sums over "chains".
        """
        cfg = self._local._population_cfg()
        gl, bl = pop.temperature.shape
        G, B = gl * self._gm, bl * self._bm
        lat_rows = self._gather_group(pop.best_latency, self._chains_group,
                                      self._bm, 1)
        temp_rows = self._gather_group(pop.temperature, self._chains_group,
                                       self._bm, 1)
        if draws is None:
            draws = popmod.draw_pbt(cfg, pop.rng, G, B)
        rows = popmod.PBTDraws(*(d[self._gsl] for d in draws))
        culled, inherit, new_temp, jstar = popmod.pbt_rows(
            cfg, rows, lat_rows, temp_rows)
        bsl = self._chains(bl)
        culled, inherit, new_temp = culled[:, bsl], inherit[:, bsl], \
            new_temp[:, bsl]
        cols = torch.arange(bsl.start, bsl.stop, device=jstar.device)
        onehot = cols[None, :] == jstar[:, None]                 # (G_l, B_l)
        group = self._chains_group
        lat_star, = self._sum(
            [torch.where(onehot, pop.best_latency, 0.0).sum(dim=1)], group)
        fine_star, = self._sum(
            [(pop.best_fine * onehot[:, :, None]).sum(dim=1)], group)
        new_zs = []
        for g, e in enumerate(self.engines):
            if use_greedy:
                z_src = e.greedy_state()
            else:
                z_src, = self._sum([torch.where(
                    onehot[g][:, None, None], zs[g], 0.0).sum(dim=0)], group)
            new_zs.append(torch.where(culled[g][:, None, None], z_src[None],
                                      zs[g]))
        new_pop = pop._replace(
            temperature=new_temp,
            best_latency=torch.where(inherit, lat_star[:, None],
                                     pop.best_latency),
            best_fine=torch.where(inherit[..., None], fine_star[:, None],
                                  pop.best_fine))
        return new_pop, new_zs


class TilePipeline:
    """A reward pipeline over one rank's tile, scoring the grid's windows:
    it scores the rank's (slots, chains) of each window with its own
    ``RewardPipeline`` and all-gathers the (T, G, B) rewards and
    latencies."""

    def __init__(self, pipeline, engine: ShardedRolloutEngine):
        self.pipeline = pipeline
        self.engine = engine

    @property
    def fused(self) -> bool:
        return self.pipeline.fused

    def score_window(self, fines: Sequence[torch.Tensor]):
        """The grid's G × (T, B, V_g) placements → (rewards, latencies),
        (T, G, B) float64 on the host."""
        e = self.engine
        bsl = e._chains(fines[0].shape[1] // e._bm)
        rewards, latencies = self.pipeline.score_window(
            [f[:, bsl] for f in fines[e._gsl]])
        both = torch.as_tensor(np.stack([rewards, latencies]),
                               device=e._device)
        full = e._gather_grid(both, 2).cpu().numpy()
        return full[0], full[1]
