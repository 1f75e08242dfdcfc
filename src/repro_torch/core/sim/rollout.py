"""Window rollout and its Eq.-14 replay for B chains on one graph, and for
(G, B) chains on G graphs.

Port of ``repro/core/sim/rollout.py::RolloutEngine``: the window rollout
(sampled or greedy) and replay, and the population methods.  The reference
vmaps one step over a padded (G, V_max) batch with node and edge masks; its
padding contract makes every graph's slot compute what that graph computes
unpadded.  :class:`MultiRolloutEngine` therefore runs one
:class:`RolloutEngine` a graph, each on the graph's own unpadded tensors,
all sharing one policy, and sums their replay losses into one Eq.-14
update averaged over the G·B chains, as the reference does; the
single-graph search is its G=1 case.

The reference samples with per-step PRNG keys and replays the
window differentiably from the same keys.  Here the sampling pass runs under
``torch.no_grad()`` and records what the replay needs to retrace the
identical window: each step's edge keep-masks, parse-dropout keeps, Gumbel
noise and temperatures, and the cluster labels and coarse actions it
decided.

The first replay of a window (``rederive=False``) re-runs the T steps with
autograd on the recorded labels and actions; with the sampling parameters it
computes the same labels and scores the same actions, so the gradient is the
reference's Eq. 14 including the GPN's straight-through gates.  A later
epoch of a ``k_epochs > 1`` update (``rederive=True``) replays the recorded
draws under the updated weights and derives the labels and actions anew,
as the reference does when it replays the same keys with new parameters: the
actions it scores may differ from the ones that were rewarded.

Random draws come from :class:`ChainStreams` (one ``torch.Generator`` per
chain) or are injected whole as a :class:`WindowNoise` — the tests feed the
reference's own masks and Gumbel noise that way.

The corpus trainer's counterpart of the reference's ``DynamicRolloutEngine``
is this same layout: one :class:`MultiRolloutEngine` an episode over the
episode's sampled slots, each a :class:`RolloutEngine` of its graph,
unpadded (a slot may repeat a graph).  The reference passes each episode's
graphs to its jitted window functions as a ``GraphOperands`` tuple padded to
the bucket's shape, so that jit compiles once a bucket rather than once a
subset, and counts the shapes it compiled (``shape_keys_seen``).  The port
traces nothing and compiles nothing per shape, so it needs neither: an
engine over the sampled graphs is a few tensor references, and the per-graph
inputs (``x0``, the ``GCNGraph``) are cached by corpus index in the trainer.

The device head (``dev_feats``) places on the fleet's D devices, so its
Gumbel noise is (V, D) whatever ``cfg.num_devices`` says.  Its capacity mask
(``action_mask``) enters every step the engine takes — sampling, both kinds
of replay and the greedy decode of a restart — so the replayed distribution
is the sampled one (the Eq.-14 exactness).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..._device import seeded_generator
from ...kernels.gcn_spmm import GCNGraph
from ..train import population as popmod

__all__ = ["ChainStreams", "WindowNoise", "WindowRecord", "RolloutEngine",
           "MultiRolloutEngine", "pad_placements"]


class WindowNoise(NamedTuple):
    """Injected random draws for a whole window."""

    keep: torch.Tensor     # (T, B, E) 0/1 — edge dropout keep-mask
    gumbel: torch.Tensor   # (T, B, V, D) — Gumbel noise of the action sample
    parse_keep: Optional[torch.Tensor] = None   # (T, B, E) 0/1 parse dropout


class WindowRecord(NamedTuple):
    """What the sampling pass drew and decided, per step."""

    keep: torch.Tensor     # (T, B, E) f32
    labels: torch.Tensor   # (T, B, V) i64
    actions: torch.Tensor  # (T, B, V) i64 — coarse placement per slot
    gumbel: torch.Tensor   # (T, B, V, D) f32
    parse_keep: Optional[torch.Tensor] = None    # (T, B, E) f32
    temperature: Optional[torch.Tensor] = None   # (B,) f32, the window's


class ChainStreams:
    """One generator per chain on ``device``.

    Chain b's stream depends only on (seed, b), so chain 0 draws the same
    numbers whatever the number of chains.
    """

    def __init__(self, seed: int, num_chains: int, device):
        self.generators = [seeded_generator([seed, b], device)
                           for b in range(num_chains)]
        self.device = torch.device(device)

    @classmethod
    def of(cls, generators: Sequence[torch.Generator]) -> "ChainStreams":
        """Streams over given generators, one a chain (all on one device)."""
        self = cls.__new__(cls)
        self.generators = list(generators)
        self.device = self.generators[0].device
        return self

    def draw(self, num_edges: int, num_nodes: int, num_devices: int,
             edge_dropout: float):
        """→ keep (B, E) f32 0/1 with P(keep) = 1 − edge_dropout, and Gumbel
        noise (B, V, D)."""
        tiny = torch.finfo(torch.float32).tiny
        keep, gumbel = [], []
        for g in self.generators:
            u = torch.rand(num_edges + num_nodes * num_devices, generator=g,
                           device=self.device)
            keep.append((u[:num_edges] < 1.0 - edge_dropout).float())
            ug = u[num_edges:].clamp_min(tiny).reshape(num_nodes,
                                                       num_devices)
            gumbel.append(-torch.log(-torch.log(ug)))
        return torch.stack(keep), torch.stack(gumbel)

    def draw_parse_keep(self, num_edges: int,
                        parse_dropout: float) -> torch.Tensor:
        """→ the parse-dropout keep (B, E) f32 0/1, P(keep) = 1 −
        parse_dropout.  A step draws it after :meth:`draw`, and only when
        ``dropout_parsing > 0``, so the default config's streams are what
        they were without it."""
        return torch.stack([
            (torch.rand(num_edges, generator=g, device=self.device)
             < 1.0 - parse_dropout).float() for g in self.generators])

    def step(self, cfg, num_edges: int, num_nodes: int, num_devices: int):
        """One step's draws for ``cfg`` over ``num_devices`` devices →
        (keep, gumbel, parse_keep or None)."""
        keep, gumbel = self.draw(num_edges, num_nodes, num_devices,
                                 cfg.dropout_network)
        parse_keep = (self.draw_parse_keep(num_edges, cfg.dropout_parsing)
                      if cfg.dropout_parsing > 0 else None)
        return keep, gumbel, parse_keep


def pad_placements(fines: Sequence[torch.Tensor],
                   width: int) -> torch.Tensor:
    """G × (T, B, V_g) placements → (T, G, B, width), zero at pads."""
    T, B = fines[0].shape[:2]
    out = fines[0].new_zeros(T, len(fines), B, width)
    for g, f in enumerate(fines):
        out[:, g, :, :f.shape[2]] = f
    return out


def policy_grads(policy, loss: torch.Tensor) -> List[torch.Tensor]:
    """∇ of ``loss`` for every parameter of ``policy``, in
    ``policy.parameters()`` order."""
    params = list(policy.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    # An edge-free graph leaves φ out of the loss: its gradient is 0.
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


class RolloutEngine:
    """Samples and replays rollout windows of one graph for B chains.

    ``policy`` is the port's ``HSDAGPolicy``; its ``step`` is one Alg.-1
    iteration.  ``x0`` (V, d) holds the graph's initial features.
    ``population`` (a ``PopulationConfig``) enables the population methods.
    ``dev_feats`` (D, F_dev) is the device head's fleet table and
    ``action_mask`` (V, D) bool its capacity mask (None: unmasked).
    """

    def __init__(self, policy, cfg, *, x0: torch.Tensor, graph: GCNGraph,
                 dev_feats: Optional[torch.Tensor] = None,
                 action_mask: Optional[torch.Tensor] = None):
        self.policy = policy
        self.cfg = cfg
        self.x0 = x0
        self.graph = graph
        self.dev_feats = dev_feats
        self.action_mask = action_mask
        self.num_devices = (cfg.num_devices if dev_feats is None
                            else dev_feats.shape[0])

    def _x0(self, num_chains: int) -> torch.Tensor:
        return self.x0.expand(num_chains, *self.x0.shape)

    def _draws(self, t: int, num_chains: int,
               streams: Optional[ChainStreams],
               noise: Optional[WindowNoise]):
        """Step t's (keep, gumbel, parse_keep): all-ones keep and no noise
        for a greedy decode (neither source given), else from ``noise`` or
        ``streams``."""
        V, E = self.graph.num_nodes, self.graph.num_edges
        if noise is not None:
            return (noise.keep[t].float(), noise.gumbel[t],
                    None if noise.parse_keep is None
                    else noise.parse_keep[t].float())
        if streams is not None:
            return streams.step(self.cfg, E, V, self.num_devices)
        return torch.ones(num_chains, E, device=self.x0.device), None, None

    def rollout_window(self, z: torch.Tensor, *, num_steps: int,
                       start_first: bool,
                       streams: Optional[ChainStreams] = None,
                       noise: Optional[WindowNoise] = None,
                       temperature: Optional[torch.Tensor] = None,
                       greedy: bool = False):
        """Sample ``num_steps`` steps of every chain from state z (B, V, ·),
        at the per-chain ``temperature`` (B,) when given; ``greedy`` decodes
        without dropout or noise instead.  The draws come from ``streams``
        or are injected whole as ``noise``.

        → (z_final, record, fines (T, B, V) i64, ngroups (T, B) i64).
        """
        if (streams is not None) + (noise is not None) != (not greedy):
            raise ValueError("pass exactly one of streams= or noise=, or "
                             "neither with greedy=True")
        B = z.shape[0]
        x0 = self._x0(B)
        rows = []
        fines, ngroups = [], []
        with torch.no_grad():
            for t in range(num_steps):
                keep, gumbel, parse_keep = self._draws(t, B, streams, noise)
                out = self.policy.step(z, x0, self.graph, keep,
                                       first=start_first and t == 0,
                                       state_norm=self.cfg.state_norm,
                                       greedy=greedy, gumbel=gumbel,
                                       parse_keep=parse_keep,
                                       temperature=temperature,
                                       dev_feats=self.dev_feats,
                                       action_mask=self.action_mask)
                rows.append((keep, out.parse.labels,
                             out.policy.coarse_placement, gumbel,
                             parse_keep))
                fines.append(out.policy.fine_placement)
                ngroups.append(out.parse.num_groups)
                z = out.z_next
        cols = [None if col[0] is None else torch.stack(col)
                for col in zip(*rows)]
        record = WindowRecord(*cols, temperature=temperature)
        return z, record, torch.stack(fines), torch.stack(ngroups)

    def window_grads(self, z0: torch.Tensor, record: WindowRecord,
                     weights: torch.Tensor, *, start_first: bool,
                     rederive: bool = False) -> List[torch.Tensor]:
        """∇θ of the Eq.-14 loss over the recorded window, averaged over the
        B chains; ``weights`` (T, B).  ``rederive`` replays the recorded
        draws and derives the labels and actions under the current weights
        (epochs ≥ 2 of a ``k_epochs`` update) instead of scoring the
        recorded ones.  → one gradient per policy parameter, in
        ``policy.parameters()`` order."""
        total = self.window_loss(z0, record, weights,
                                 start_first=start_first, rederive=rederive)
        return policy_grads(self.policy, total / z0.shape[0])

    def window_loss(self, z0: torch.Tensor, record: WindowRecord,
                    weights: torch.Tensor, *, start_first: bool,
                    rederive: bool = False) -> torch.Tensor:
        """The Eq.-14 loss of the recorded window summed over its steps and
        chains (see :meth:`window_grads`), differentiable in the policy."""
        B = z0.shape[0]
        x0 = self._x0(B)
        total = torch.zeros((), device=z0.device)
        z = z0
        for t in range(record.keep.shape[0]):
            chosen = ({"gumbel": record.gumbel[t]} if rederive else
                      {"labels": record.labels[t],
                       "actions": record.actions[t]})
            out = self.policy.step(
                z, x0, self.graph, record.keep[t],
                first=start_first and t == 0,
                state_norm=self.cfg.state_norm,
                parse_keep=(None if record.parse_keep is None
                            else record.parse_keep[t]),
                temperature=record.temperature, dev_feats=self.dev_feats,
                action_mask=self.action_mask, **chosen)
            loss = -out.policy.logp * weights[t] \
                - self.cfg.entropy_coef * out.policy.entropy
            total = total + loss.sum()
            z = out.z_next
        return total

    def greedy_state(self) -> torch.Tensor:
        """The state after one greedy decode of the graph → (V, d): what a
        greedy restart re-seeds culled chains from."""
        return self.rollout_window(self.x0[None], num_steps=1,
                                   start_first=True, greedy=True)[0][0]


class MultiRolloutEngine:
    """Samples and replays (G, B) rollout windows over G graphs.

    ``engines`` holds one :class:`RolloutEngine` a graph, all over one
    policy (each with its graph's capacity mask, when it has one).  The
    (G, B) state is a list of G (B, V_g, d) tensors and placements come
    back per graph as (T, B, V_g).  ``population`` (a ``PopulationConfig``)
    enables the population methods over the G rows, whose best-placement
    record is the reference's (G, B, V_max) one (:meth:`pad`).
    """

    def __init__(self, engines: Sequence[RolloutEngine], population=None):
        self.engines = list(engines)
        self.policy = self.engines[0].policy
        self.population = population
        self.num_nodes = [e.graph.num_nodes for e in self.engines]

    @property
    def num_graphs(self) -> int:
        return len(self.engines)

    def initial_state(self, num_chains: int) -> List[torch.Tensor]:
        """Every chain of graph g at its initial features → G (B, V_g, d)."""
        return [e._x0(num_chains) for e in self.engines]

    def rollout_window(self, zs: Sequence[torch.Tensor], *, num_steps: int,
                       start_first: bool,
                       streams: Optional[Sequence[ChainStreams]] = None,
                       noise: Optional[Sequence[WindowNoise]] = None,
                       temperature: Optional[torch.Tensor] = None):
        """Sample a window of every graph's B chains, graph g's draws from
        ``streams[g]`` or ``noise[g]``, at the (G, B) ``temperature`` when
        given → (zs, records, fines: G × (T, B, V_g), ngroups (T, G, B))."""
        out = [e.rollout_window(
            zs[g], num_steps=num_steps, start_first=start_first,
            streams=None if streams is None else streams[g],
            noise=None if noise is None else noise[g],
            temperature=None if temperature is None else temperature[g])
            for g, e in enumerate(self.engines)]
        zs, records, fines, ngroups = zip(*out)
        return list(zs), list(records), list(fines), torch.stack(ngroups, 1)

    def pad(self, fines: Sequence[torch.Tensor],
            width: Optional[int] = None) -> torch.Tensor:
        """G × (T, B, V_g) placements → (T, G, B, width), zero at pads;
        ``width`` defaults to the largest graph (the corpus trainer pads to
        its bucket's, as the reference's population record is)."""
        return pad_placements(
            fines, max(self.num_nodes) if width is None else int(width))

    def window_grads(self, zs: Sequence[torch.Tensor],
                     records: Sequence[WindowRecord], weights: torch.Tensor,
                     *, start_first: bool,
                     rederive: bool = False) -> List[torch.Tensor]:
        """∇θ of the Eq.-14 loss over every graph's recorded window,
        averaged over the G·B chains (the reference's ``total / (G·B)``);
        ``weights`` (T, G, B).  One backward pass over the G replays."""
        total = self.window_loss(zs, records, weights,
                                 start_first=start_first, rederive=rederive)
        return policy_grads(self.policy,
                            total / (self.num_graphs * zs[0].shape[0]))

    def window_loss(self, zs: Sequence[torch.Tensor],
                    records: Sequence[WindowRecord], weights: torch.Tensor,
                    *, start_first: bool,
                    rederive: bool = False) -> torch.Tensor:
        """The Eq.-14 loss of every graph's recorded window, summed over
        graphs, steps and chains (see :meth:`window_grads`)."""
        total = None
        for g, e in enumerate(self.engines):
            loss = e.window_loss(zs[g], records[g], weights[:, g],
                                 start_first=start_first, rederive=rederive)
            total = loss if total is None else total + loss
        return total

    def greedy_decode(self) -> List[torch.Tensor]:
        """One greedy decode of every graph with the shared policy (no
        dropout, no noise, as ``place()``) → G × (V_g,) placements."""
        return [e.rollout_window(e.x0[None], num_steps=1, start_first=True,
                                 greedy=True)[2][0, 0]
                for e in self.engines]

    # ------------------------------------------------------- population API
    def init_population(self, generator: torch.Generator, *,
                        num_chains: int, temperatures=None,
                        num_nodes: Optional[int] = None
                        ) -> popmod.ChainState:
        """Fresh (G, B) population state, best placements padded to
        ``num_nodes`` (default: the largest graph); its draws come from
        ``generator``."""
        return popmod.init_chain_state(
            self._population_cfg(), generator, num_graphs=self.num_graphs,
            num_chains=num_chains,
            num_nodes=max(self.num_nodes) if num_nodes is None
            else num_nodes, temperatures=temperatures)

    def update_population(self, pop: popmod.ChainState, fines: torch.Tensor,
                          latencies) -> popmod.ChainState:
        """Fold a window's (T, G, B, V_max) placements and (T, G, B)
        latencies into the chain-best records."""
        lat = torch.as_tensor(np.asarray(latencies), dtype=torch.float32,
                              device=fines.device)
        return popmod.update_chain_bests(pop, fines, lat)

    def pbt_step(self, pop: popmod.ChainState, zs: Sequence[torch.Tensor],
                 *, use_greedy: bool = False,
                 draws: Optional[popmod.PBTDraws] = None):
        """One PBT round over the G rows → (pop, zs).

        In row g, culled chains take the state of the row's best chain
        ``zs[g][jstar[g]]`` (or graph g's greedy decode's) and new
        temperatures; culled and exchanged chains inherit that chain's best
        record.  ``draws`` (G rows) replaces the draws from ``pop.rng``.
        """
        cfg = self._population_cfg()
        G, B = pop.temperature.shape
        if draws is None:
            draws = popmod.draw_pbt(cfg, pop.rng, G, B)
        culled, inherit, new_temp, jstar = popmod.pbt_rows(
            cfg, draws, pop.best_latency, pop.temperature)
        new_zs = []
        for g, e in enumerate(self.engines):
            j = jstar[g]
            z_src = e.greedy_state() if use_greedy else zs[g][j]
            new_zs.append(torch.where(culled[g][:, None, None], z_src[None],
                                      zs[g]))
        rows = torch.arange(G, device=jstar.device)
        lat_star = pop.best_latency[rows, jstar]                   # (G,)
        fine_star = pop.best_fine[rows, jstar]                     # (G, V)
        new_pop = pop._replace(
            temperature=new_temp,
            best_latency=torch.where(inherit, lat_star[:, None],
                                     pop.best_latency),
            best_fine=torch.where(inherit[..., None], fine_star[:, None],
                                  pop.best_fine))
        return new_pop, new_zs

    def _population_cfg(self):
        if self.population is None:
            raise ValueError(
                "population path requested but the engine was built "
                "without population= (pass a PopulationConfig)")
        return self.population
