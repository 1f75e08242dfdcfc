"""HSDAG — the paper's framework end to end (§2, Fig. 1, Alg. 1), PyTorch.

Port of ``repro/core/hsdag.py`` for the batched search with the ``level``
reward backend and the greedy decode::

    graph  = inception_v3()
    arrays = extract_features(graph)
    agent  = HSDAG(HSDAGConfig(batch_chains=16, engine="level"))
    result = agent.search(graph, arrays, platform=paper_platform())
    placement = agent.place(arrays)

Each episode samples one window of ``update_timestep`` steps for
``batch_chains`` parallel REINFORCE chains (encode → parse → place → state
update), scores every placement of the window in one launch of the level
kernel, and updates the policy with the exact Eq.-14 gradient of a replay of
the same window.  Everything runs on ``device`` (the card unless the caller
passes ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..kernels.gcn_spmm import GCNGraph, gcn_graph
from ..optim.adamw import Adam
from .costmodel import Platform
from .features import GraphArrays
from .gnn import Encoder
from .gpn import GPN, ParseResult, gpn_apply
from .graph import CompGraph
from .policy import DensePolicy, PolicyOutput, policy_apply
from .reinforce import RunningBaseline, step_weights
from .sim.pipeline import RewardPipeline
from .sim.rollout import ChainStreams, RolloutEngine

__all__ = ["HSDAGConfig", "HSDAG", "HSDAGPolicy", "SearchResult",
           "StepOutput"]

#: every engine name the reference accepts; the port runs "level" and names
#: the ROADMAP.md item that ports each of the others.
_ENGINES = ("auto", "scalar", "batched", "reference", "scan", "level")
_NOT_PORTED = {
    "auto": "ROADMAP.md 'Modules to port' item 2 (the node-scan simulator, "
            "the default reward of engine='auto'/'batched')",
    "batched": "ROADMAP.md 'Modules to port' item 2 (the node-scan "
               "simulator, the default reward of engine='auto'/'batched')",
    "scan": "ROADMAP.md 'Modules to port' item 2 (the node-scan simulator)",
    "reference": "ROADMAP.md 'Modules to port' item 3 (the host reference "
                 "backend)",
    "scalar": "ROADMAP.md 'Modules to port' item 5 (the scalar reference "
              "loop)",
}


@dataclasses.dataclass(frozen=True)
class HSDAGConfig:
    """Appendix H, Table 6 defaults — the reference's fields, unchanged, so a
    config round-trips between the two packages through ``to_json``."""

    num_devices: int = 2
    hidden_channel: int = 128
    layer_trans: int = 2
    layer_gnn: int = 2
    layer_parsingnet: int = 2
    gnn_model: str = "gcn"
    dropout_network: float = 0.2
    dropout_parsing: float = 0.0
    link_ignore_self_loop: bool = True
    activation_final: bool = True
    learning_rate: float = 1e-4
    max_episodes: int = 100
    update_timestep: int = 20
    k_epochs: int = 1
    gamma: float = 0.99
    entropy_coef: float = 0.0
    reward_to_go: bool = False
    use_baseline: bool = False
    normalize_weights: bool = False
    state_norm: bool = True
    seed: int = 0
    batch_chains: int = 1
    engine: str = "auto"
    head: str = "dense"

    def __post_init__(self):
        if self.engine not in _ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; expected one "
                             f"of {_ENGINES}")
        if self.head not in ("dense", "device"):
            raise ValueError(f"unknown head {self.head!r}; "
                             f"expected 'dense' or 'device'")

    def to_json(self) -> str:
        """Canonical JSON form (sorted keys) — ``from_json`` round-trips it."""
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, doc: Union[str, Dict]) -> "HSDAGConfig":
        """Inverse of :meth:`to_json` (also accepts the dict form); unknown
        fields are rejected by name."""
        data = json.loads(doc) if isinstance(doc, str) else dict(doc)
        if not isinstance(data, dict):
            raise ValueError(
                f"HSDAGConfig JSON must be an object, got {type(data).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(
                f"unknown HSDAGConfig fields {unknown}; known fields: "
                f"{sorted(known)}")
        return cls(**data)


def _check_ported(cfg: HSDAGConfig, engine: str) -> None:
    if engine in _NOT_PORTED:
        raise NotImplementedError(
            f"engine={engine!r} is not ported to PyTorch yet; "
            f"{_NOT_PORTED[engine]} ports it. Use engine='level'.")
    if cfg.head != "dense":
        raise NotImplementedError(
            "head='device' is not ported yet; ROADMAP.md 'Modules to port' "
            "item 7 (platforms) ports it")
    if cfg.gnn_model != "gcn":
        raise NotImplementedError(
            f"gnn_model={cfg.gnn_model!r} is not ported yet; ROADMAP.md "
            f"'Modules to port' item 4 (model) ports it")
    if cfg.dropout_parsing != 0.0 or cfg.k_epochs != 1:
        raise NotImplementedError(
            "dropout_parsing > 0 and k_epochs > 1 are not ported yet; "
            "ROADMAP.md 'Modules to port' item 5 (search) ports them")


class StepOutput(NamedTuple):
    policy: PolicyOutput
    parse: ParseResult
    z_next: torch.Tensor


def _rms_normalize(z: torch.Tensor) -> torch.Tensor:
    """Per chain: z / sqrt(mean(z²) + 1e-6) over all of (V, d)."""
    rms = torch.sqrt(torch.mean(torch.square(z), dim=(1, 2), keepdim=True)
                     + 1e-6)
    return z / rms


class HSDAGPolicy(nn.Module):
    """Encoder (Eq. 6), GPN (Eq. 7–11) and dense placement head (§2.5)."""

    def __init__(self, d_in: int, hidden: int, num_devices: int, *,
                 layer_trans: int = 2, layer_gnn: int = 2,
                 layer_parsingnet: int = 2, policy_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc = Encoder(d_in, hidden, layer_trans=layer_trans,
                           layer_gnn=layer_gnn, generator=generator)
        self.gpn = GPN(hidden, layer_parsingnet=layer_parsingnet,
                       generator=generator)
        self.pol = DensePolicy(hidden, num_devices, layers=policy_layers,
                               generator=generator)

    def step(self, z: torch.Tensor, x0: torch.Tensor, graph: GCNGraph,
             keep: torch.Tensor, *, first: bool, state_norm: bool = True,
             greedy: bool = False, gumbel: Optional[torch.Tensor] = None,
             labels: Optional[torch.Tensor] = None,
             actions: Optional[torch.Tensor] = None) -> StepOutput:
        """One Alg.-1 iteration for B chains: encode → parse → place → state
        update.  ``keep`` (B, E) is the edge-dropout mask (all ones when not
        exploring); ``greedy``/``gumbel``/``actions`` pick the placement
        (see ``policy_apply``); ``labels`` replays a recorded parse."""
        z_enc = self.enc(x0 if first else z, graph, keep, transform=first)
        parse = gpn_apply(self.gpn, z_enc, graph.src, graph.dst,
                          labels=labels)
        pol = policy_apply(self.pol, parse.pooled_z, parse.active,
                           parse.labels, greedy=greedy, gumbel=gumbel,
                           actions=actions)
        # Alg. 1 line 10: Z_v ← Z_v + Z_{v'}.
        z_next = z_enc + torch.gather(
            parse.pooled_z, 1, parse.labels[..., None].expand_as(z_enc))
        if state_norm:
            z_next = _rms_normalize(z_next)
        return StepOutput(pol, parse, z_next)


class SearchResult(NamedTuple):
    best_placement: np.ndarray
    best_latency: float
    history: List[dict]          # per-episode stats
    params: HSDAGPolicy
    baseline_latencies: Dict[str, float]
    wall_time_s: float
    num_evaluations: int = 0     # placements scored during the search
    evals_per_sec: float = 0.0   # rollout throughput (placements / wall-s)
    chain_best: Optional[np.ndarray] = None   # (B,) per-chain best latency


class HSDAG:
    """The framework object: owns the policy, its optimizer and the device."""

    def __init__(self, cfg: HSDAGConfig = HSDAGConfig(), *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy: Optional[HSDAGPolicy] = None
        self._opt: Optional[Adam] = None

    # ------------------------------------------------------------------ init
    def init(self, arrays: GraphArrays) -> HSDAGPolicy:
        """Fresh parameters (reference init distribution, seeded by
        ``cfg.seed``) for graphs featurized like ``arrays``."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed)
        self._set_policy(HSDAGPolicy(
            arrays.x.shape[1], cfg.hidden_channel, cfg.num_devices,
            layer_trans=cfg.layer_trans, layer_gnn=cfg.layer_gnn,
            layer_parsingnet=cfg.layer_parsingnet, generator=gen))
        return self.policy

    def load_params(self, tree: Dict) -> HSDAGPolicy:
        """Adopt a reference parameter tree (numpy leaves, e.g. from
        ``checkpoint.convert.load_reference_policy``)."""
        from ..checkpoint.convert import params_from_numpy
        self._set_policy(params_from_numpy(tree))
        return self.policy

    def _set_policy(self, policy: HSDAGPolicy) -> None:
        self.policy = policy.to(self.device)
        self._opt = Adam(self.policy.parameters(), self.cfg.learning_rate)

    def apply_grads(self, grads: List[torch.Tensor]) -> None:
        """One optimizer step (the Eq.-14 update); ``grads`` in
        ``policy.parameters()`` order."""
        self._opt.update(grads)

    def _graph(self, arrays: GraphArrays) -> GCNGraph:
        return gcn_graph(arrays.edges, arrays.num_nodes, self.device)

    def rollout_engine(self, arrays: GraphArrays) -> RolloutEngine:
        """The window rollout/replay engine for one graph."""
        x0 = torch.as_tensor(arrays.x, device=self.device)
        return RolloutEngine(self.policy, self.cfg, x0=x0,
                             graph=self._graph(arrays))

    # ---------------------------------------------------------------- search
    def search(self, graph: CompGraph, arrays: GraphArrays, *,
               platform: Platform, engine: Optional[str] = None,
               verbose: bool = False) -> SearchResult:
        """Run the RL search (Alg. 1) and return the best sampled placement.

        ``engine`` overrides ``cfg.engine``; the port runs ``"level"``.
        """
        cfg = self.cfg
        engine = engine if engine is not None else cfg.engine
        if engine not in _ENGINES:
            raise ValueError(f"unknown engine {engine!r}; expected one of "
                             f"{_ENGINES}")
        _check_ported(cfg, engine)
        if cfg.num_devices > platform.num_devices:
            # Device ids ≥ platform.num_devices would index past the
            # simulator's tables; fail up front.
            raise ValueError(
                f"cfg.num_devices={cfg.num_devices} exceeds the platform's "
                f"{platform.num_devices} devices")
        nchains = max(1, cfg.batch_chains)
        t_start = time.perf_counter()
        if self.policy is None:
            self.init(arrays)
        pipeline = RewardPipeline.from_platform(graph, platform, "level",
                                                device=self.device)
        rollout = self.rollout_engine(arrays)
        streams = ChainStreams(cfg.seed, nchains, self.device)
        baseline = RunningBaseline() if cfg.use_baseline else None

        best_latency = float("inf")
        best_placement = np.zeros(arrays.num_nodes, dtype=np.int64)
        chain_best = np.full(nchains, np.inf)
        history: List[dict] = []
        z0_window = rollout.x0.expand(nchains, *rollout.x0.shape)
        first_of_window = True
        tsteps = cfg.update_timestep

        for episode in range(cfg.max_episodes):
            t_ep = time.perf_counter()
            z, record, fines, ngroups = rollout.rollout_window(
                z0_window, num_steps=tsteps, start_first=first_of_window,
                streams=streams)
            rewards, latencies = pipeline.score_window(fines)
            fines_np = fines.cpu().numpy()

            # Bookkeeping in (t, b) order — the reference's order (EMA
            # baseline order and strict-< best tie-breaks matter).
            for t in range(tsteps):
                for b in range(nchains):
                    if baseline is not None:
                        baseline.update(rewards[t, b])
                    if latencies[t, b] < best_latency:
                        best_latency = float(latencies[t, b])
                        best_placement = fines_np[t, b].astype(np.int64)
            chain_best = np.minimum(chain_best, latencies.min(axis=0))

            # ---- policy update over the (B, T) window (Eq. 14) ----
            weights_bt = step_weights(
                rewards.T, cfg.gamma, reward_to_go=cfg.reward_to_go,
                baseline=(baseline.value if baseline is not None else None),
                normalize=cfg.normalize_weights)
            weights = torch.as_tensor(weights_bt.T.copy(), device=self.device)
            self.apply_grads(rollout.window_grads(
                z0_window, record, weights, start_first=first_of_window))
            z0_window = z
            first_of_window = False
            history.append({
                "episode": episode,
                "mean_reward": float(np.mean(rewards)),
                "best_latency": best_latency,
                "mean_groups": float(ngroups.float().mean()),
                "wall_s": time.perf_counter() - t_ep,
            })
            if verbose:
                h = history[-1]
                print(f"ep {episode:3d} reward {h['mean_reward']:.4g} "
                      f"best {best_latency:.6f}s groups {h['mean_groups']:.1f}"
                      f" chains {nchains}")

        wall = time.perf_counter() - t_start
        n_evals = cfg.max_episodes * tsteps * nchains
        return SearchResult(best_placement, best_latency, history,
                            self.policy, {}, wall, n_evals,
                            n_evals / max(wall, 1e-9), chain_best)

    # ------------------------------------------------------------- inference
    def place(self, arrays: GraphArrays) -> np.ndarray:
        """One greedy forward placement with the current policy → (V,)."""
        if self.policy is None:
            raise RuntimeError("call init(), load_params() or search() first")
        x0 = torch.as_tensor(arrays.x, device=self.device)[None]
        graph = self._graph(arrays)
        keep = torch.ones(1, graph.num_edges, device=self.device)
        with torch.no_grad():
            out = self.policy.step(x0, x0, graph, keep, first=True,
                                   state_norm=self.cfg.state_norm,
                                   greedy=True)
        return out.policy.fine_placement[0].cpu().numpy()
