"""HSDAG — the paper's framework end to end (§2, Fig. 1, Alg. 1), PyTorch.

Port of ``repro/core/hsdag.py``: the single-graph search and the decode::

    graph  = inception_v3()
    arrays = extract_features(graph)
    agent  = HSDAG(HSDAGConfig(batch_chains=16))
    result = agent.search(graph, arrays, platform=paper_platform())
    placement = agent.place(arrays)

and joint training of one policy over several graphs, with zero-shot
transfer to a held-out graph and the reference's checkpoint format::

    trainer = MultiGraphTrainer(HSDAGConfig(batch_chains=8))
    res = trainer.train([inception_v3(), resnet50()],
                        platform=paper_platform())
    placement, latency = trainer.evaluate_zero_shot(
        bert_base(), platform=paper_platform())
    trainer.save_policy("ckpt/joint")      # the reference's restore reads it

``head="device"`` conditions the policy on a fleet (``platforms``)::

    fleet = nvlink_island(2, 4)
    agent = HSDAG(HSDAGConfig(batch_chains=16, head="device",
                              num_devices=fleet.num_devices))
    result = agent.search(graph, arrays, platform=fleet)
    placement = agent.place(arrays)          # decodes on the bound fleet

Each episode samples one window of ``update_timestep`` steps for
``batch_chains`` parallel REINFORCE chains (encode → parse → place → state
update), scores every placement of the window (in one launch of the level
kernel for the ``scan`` and ``level`` backends, on the host for the
``reference`` backend or a ``reward_fn``), and updates the policy
``k_epochs`` times with the Eq.-14 gradient of a replay of the same window.
``population=`` turns the chains into a PBT population
(``core/train/population.py``).  The reference's one-placement-at-a-time
loop (``engine="scalar"``) is the batched loop at one chain with a host
reward, which follows the same trajectory.  ``HSDAG.init`` draws the
reference's initial weights for ``cfg.seed`` (``core/prng.py``), so a search
of either package for a seed starts from the same weights.  Everything runs
on ``device`` (the card unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..kernels.gcn_spmm import GCNGraph, gcn_graph
from ..optim.adamw import Adam
from .costmodel import Platform, simulate
from .features import (FeatureConfig, GraphArrays, extract_features,
                       shared_feature_config)
from . import prng
from .gnn import Encoder, encoder_init
from .gpn import GPN, ParseResult, gpn_apply, gpn_init
from .graph import CompGraph
from .policy import (DensePolicy, DevicePolicy, PolicyOutput, policy_apply,
                     policy_init)
from .reinforce import RunningBaseline
from .sim import backend_names
from .sim.pipeline import RewardPipeline
from .sim.rollout import ChainStreams, MultiRolloutEngine, RolloutEngine
from .train.loop import BestTracker, EpisodeRunner, WindowStream
from .train.population import (PopulationConfig, PopulationController,
                               population_generator)

__all__ = ["HSDAGConfig", "HSDAG", "HSDAGPolicy", "SearchResult",
           "StepOutput", "MultiGraphTrainer", "MultiSearchResult"]

#: rollout loops; every other engine names a registered simulator backend,
#: which runs the batched loop with that reward.
_LOOP_ENGINES = ("auto", "scalar", "batched")


def reward_backend(engine: str) -> str:
    """The simulator backend that scores ``engine``'s search given a
    platform: the engine itself when it names one, else ``"scan"``."""
    return engine if engine not in _LOOP_ENGINES else "scan"


def _validate_engine(engine: str) -> str:
    if engine in _LOOP_ENGINES or engine in backend_names():
        return engine
    raise ValueError(
        f"unknown engine {engine!r}; rollout loops: {_LOOP_ENGINES}; "
        f"registered simulator backends: {backend_names()}")


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
        _validate_engine(self.engine)
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


def _as_population(population) -> PopulationConfig:
    """Accept a :class:`PopulationConfig` or its JSON (dict/str) form."""
    if isinstance(population, PopulationConfig):
        return population
    if isinstance(population, (dict, str)):
        return PopulationConfig.from_json(population)
    raise TypeError(
        f"population must be a PopulationConfig or its JSON form, "
        f"got {type(population).__name__}")


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
    """Encoder (Eq. 6), GPN (Eq. 7–11) and placement head (§2.5): the dense
    head, or the device head over ``dev_feat_dim`` fleet features."""

    def __init__(self, d_in: int, hidden: int, num_devices: int, *,
                 layer_trans: int = 2, layer_gnn: int = 2,
                 layer_parsingnet: int = 2, policy_layers: int = 2,
                 gnn_model: str = "gcn", head: str = "dense",
                 dev_feat_dim: Optional[int] = None):
        super().__init__()
        self.enc = Encoder(d_in, hidden, layer_trans=layer_trans,
                           layer_gnn=layer_gnn, gnn_model=gnn_model)
        self.gpn = GPN(hidden, layer_parsingnet=layer_parsingnet)
        self.pol = (DevicePolicy(hidden, dev_feat_dim, layers=policy_layers)
                    if head == "device" else
                    DensePolicy(hidden, num_devices, layers=policy_layers))

    def step(self, z: torch.Tensor, x0: torch.Tensor, graph: GCNGraph,
             keep: torch.Tensor, *, first: bool, state_norm: bool = True,
             greedy: bool = False, gumbel: Optional[torch.Tensor] = None,
             labels: Optional[torch.Tensor] = None,
             actions: Optional[torch.Tensor] = None,
             parse_keep: Optional[torch.Tensor] = None,
             temperature: Optional[torch.Tensor] = None,
             dev_feats: Optional[torch.Tensor] = None,
             action_mask: Optional[torch.Tensor] = None) -> StepOutput:
        """One Alg.-1 iteration for B chains: encode → parse → place → state
        update.  ``keep`` (B, E) is the edge-dropout mask (all ones when not
        exploring) and ``parse_keep`` (B, E) the parse dropout (none by
        default); ``greedy``/``gumbel``/``actions`` pick the placement at
        the per-chain ``temperature`` (see ``policy_apply``), on the fleet
        ``dev_feats`` under the capacity ``action_mask`` for the device
        head; ``labels`` replays a recorded parse."""
        z_enc = self.enc(x0 if first else z, graph, keep, transform=first)
        parse = gpn_apply(self.gpn, z_enc, graph.src, graph.dst,
                          labels=labels, parse_keep=parse_keep)
        pol = policy_apply(self.pol, parse.pooled_z, parse.active,
                           parse.labels, greedy=greedy, gumbel=gumbel,
                           actions=actions, temperature=temperature,
                           dev_feats=dev_feats, action_mask=action_mask)
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


class MultiSearchResult(NamedTuple):
    """Outcome of one joint cross-graph training run (``train_multi``)."""

    best_placements: List[np.ndarray]   # per graph: best sampled, (V_g,) i64
    best_latencies: np.ndarray          # (G,) seconds
    greedy_placements: List[np.ndarray]  # per graph: greedy decode after train
    greedy_latencies: np.ndarray        # (G,) seconds
    history: List[dict]                 # per-episode stats
    params: HSDAGPolicy                 # the one shared policy
    wall_time_s: float
    num_evaluations: int                # placements scored (episodes·T·G·B)
    evals_per_sec: float
    chain_best: Optional[np.ndarray] = None   # (G, B) per-chain best latency


class HSDAG:
    """The framework object: owns the policy, its optimizer and the device."""

    def __init__(self, cfg: HSDAGConfig = HSDAGConfig(), *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy: Optional[HSDAGPolicy] = None
        self._opt: Optional[Adam] = None
        # Set by train_multi(): the layout held-out graphs must be
        # featurized with so the shared policy sees the same columns.
        self.feature_config: Optional[FeatureConfig] = None
        # head="device": the (D, F_dev) fleet table the policy is
        # conditioned on, set by bind_platform(); place() decodes with it.
        self._dev_feats: Optional[np.ndarray] = None

    def bind_platform(self, platform: Platform) -> None:
        """Condition the ``head="device"`` policy on ``platform``'s fleet
        (its device feature table); a no-op for ``head="dense"``.
        ``search`` calls it from its ``platform=``; a policy loaded from a
        checkpoint needs it before ``place``."""
        if self.cfg.head != "device":
            return
        from ..platforms.topology import device_feature_table
        self._dev_feats = device_feature_table(platform)

    # ------------------------------------------------------------------ init
    def init(self, arrays: GraphArrays,
             seed: Optional[int] = None) -> HSDAGPolicy:
        """The weights the reference's search for ``cfg.seed`` starts from,
        for graphs featurized like ``arrays``: its ``init`` on the second
        key of ``split(PRNGKey(cfg.seed))``, drawn by ``core/prng.py``.
        ``seed`` replaces ``cfg.seed`` in that key (the corpus trainer's
        ``rng=``)."""
        # Local import: platforms imports core.costmodel.
        from ..platforms.topology import DEV_FEATURE_DIM
        cfg = self.cfg
        k_init = prng.split(prng.key(cfg.seed if seed is None
                                     else int(seed)))[1]
        k_enc, k_gpn, k_pol = prng.split(k_init, 3)
        tree = {
            "enc": encoder_init(k_enc, arrays.x.shape[1], cfg.hidden_channel,
                                layer_trans=cfg.layer_trans,
                                layer_gnn=cfg.layer_gnn,
                                gnn_model=cfg.gnn_model),
            "gpn": gpn_init(k_gpn, cfg.hidden_channel,
                            layer_parsingnet=cfg.layer_parsingnet),
            "pol": (policy_init(k_pol, cfg.hidden_channel, cfg.num_devices)
                    if cfg.head == "dense" else
                    policy_init(k_pol, cfg.hidden_channel, cfg.num_devices,
                                head="device",
                                dev_feat_dim=DEV_FEATURE_DIM)),
        }
        return self.load_params(tree)

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

    def rollout_engine(self, arrays: GraphArrays,
                       pipeline: Optional[RewardPipeline] = None
                       ) -> RolloutEngine:
        """The window rollout/replay engine for one graph.

        The device head decodes on the bound fleet; its capacity mask
        (``SimArrays.fit_ok``) rides along, as in the reference, only with a
        ``pipeline`` whose reward the reference scores inside its rollout
        (``RewardPipeline.fused``: the ``scan`` backend), and then in
        sampling, every replay and the population's greedy restarts alike.
        """
        return self._engine_on(torch.as_tensor(arrays.x, device=self.device),
                               self._graph(arrays), pipeline)

    def _engine_on(self, x0: torch.Tensor, graph: GCNGraph,
                   pipeline: Optional[RewardPipeline] = None
                   ) -> RolloutEngine:
        """:meth:`rollout_engine` on a graph's features ``x0`` (V, d) and
        its ``GCNGraph``, already on the agent's device."""
        dev_feats = action_mask = None
        if self.cfg.head == "device":
            if self._dev_feats is None:
                raise ValueError(
                    "head='device' needs a bound platform (its device "
                    "feature table conditions the policy); call "
                    "bind_platform(platform) or pass platform= to "
                    "search/train")
            dev_feats = torch.as_tensor(self._dev_feats, device=self.device)
            if pipeline is not None and pipeline.fused:
                action_mask = torch.as_tensor(pipeline.fit_ok,
                                              device=self.device)
        return RolloutEngine(self.policy, self.cfg, x0=x0, graph=graph,
                             dev_feats=dev_feats, action_mask=action_mask)

    # ---------------------------------------------------------------- search
    def search(self, graph: CompGraph, arrays: GraphArrays, *,
               platform: Optional[Platform] = None,
               reward_fn: Optional[Callable[[np.ndarray],
                                            Tuple[float, float]]] = None,
               engine: Optional[str] = None,
               population=None,
               verbose: bool = False) -> SearchResult:
        """Run the RL search (Alg. 1) and return the best sampled placement.

        Reward source: ``platform`` (a registered simulator backend — the
        ``scan`` backend by default) or ``reward_fn`` (a host callable
        ``fn(placement) -> (reward, latency)``, called per placement).
        ``engine`` overrides ``cfg.engine``: ``"auto"`` and ``"batched"``
        run the batched loop; ``"scalar"``, and ``"auto"`` with
        ``batch_chains == 1`` and a ``reward_fn``, run the reference's
        scalar loop, which is the batched loop at one chain scoring each
        placement on the host (with ``simulate`` given a platform); a backend
        name (``"scan"``, ``"level"``, ``"reference"``) runs the batched
        loop with that reward backend.

        ``population`` (a ``PopulationConfig`` or its JSON form) makes the
        B chains a PBT population: each chain samples at its own
        temperature, and every ``cull_every`` windows the worst chains are
        re-seeded from the elites.  ``None`` leaves the batched loop as it
        is without one, draw for draw.
        """
        cfg = self.cfg
        engine = _validate_engine(engine if engine is not None
                                  else cfg.engine)
        if platform is None and reward_fn is None:
            raise ValueError("search() needs a reward source: platform= or "
                             "reward_fn")
        if platform is not None and reward_fn is not None:
            raise ValueError(
                "search() got both platform= and reward_fn — ambiguous "
                "reward source; pass exactly one")
        if platform is not None and cfg.num_devices > platform.num_devices:
            # Device ids ≥ platform.num_devices would index past the
            # simulator's tables; fail up front.
            raise ValueError(
                f"cfg.num_devices={cfg.num_devices} exceeds the platform's "
                f"{platform.num_devices} devices")
        if cfg.head == "device":
            if platform is None:
                raise ValueError(
                    "head='device' conditions the policy on a platform's "
                    "device feature table; a bare reward_fn carries no "
                    "fleet description — pass platform=")
            if engine == "scalar":
                raise ValueError(
                    "head='device' needs the batched engine (the scalar "
                    "reference loop predates device conditioning)")
            self.bind_platform(platform)
        if engine not in _LOOP_ENGINES and reward_fn is not None:
            raise ValueError(
                f"engine={engine!r} names a simulator backend but a host "
                f"reward_fn was also given — pass exactly one reward source")
        scalar = engine == "scalar" or (engine == "auto"
                                        and cfg.batch_chains == 1
                                        and platform is None)
        if population is not None:
            population = _as_population(population)
            if scalar:
                raise ValueError(
                    "population search needs the batched multi-chain loop; "
                    "engine='scalar' (and the batch_chains==1 auto-scalar "
                    "path) has no chain population")
        if scalar:
            if cfg.batch_chains != 1:
                raise ValueError("engine='scalar' requires batch_chains == 1")
            if reward_fn is None:
                def reward_fn(p, _g=graph, _plat=platform):
                    r = simulate(_g, p, _plat)
                    return r.reward, r.latency
        if reward_fn is not None:
            pipeline = RewardPipeline.from_reward_fn(
                reward_fn, num_nodes=graph.num_nodes)
        else:
            pipeline = RewardPipeline.from_platform(
                graph, platform, reward_backend(engine), device=self.device)
        # The episode loop of train_multi over this one graph, with raw
        # rewards and the EMA baseline.
        t_start = time.perf_counter()
        runner, stream = self._runner([arrays], pipeline, reward_norm="none",
                                      population=population)
        history = self._run_episodes(runner, stream, verbose)
        wall = time.perf_counter() - t_start
        n_evals = cfg.max_episodes * cfg.update_timestep * max(
            1, cfg.batch_chains)
        tracker = runner.tracker
        return SearchResult(tracker.best_placements[0],
                            float(tracker.best_latencies[0]), history,
                            self.policy, {}, wall, n_evals,
                            n_evals / max(wall, 1e-9), tracker.chain_best[0])

    def _runner(self, arrays: List[GraphArrays], pipeline: RewardPipeline,
                *, reward_norm: str,
                population: Optional[PopulationConfig] = None):
        """The episode runner over ``arrays``' graphs, scored by
        ``pipeline`` → (``EpisodeRunner``, fresh ``WindowStream``).
        Initializes the policy on the first graph if it has none."""
        cfg = self.cfg
        nchains = max(1, cfg.batch_chains)
        if self.policy is None:
            self.init(arrays[0])
        # One engine a graph over the shared policy, each with its graph's
        # capacity mask when the reward carries one.
        engine = MultiRolloutEngine(
            [self.rollout_engine(a, pipeline.graph(g))
             for g, a in enumerate(arrays)], population=population)
        # The per-graph standardization is itself a per-graph baseline; the
        # raw-scale EMA would swamp the standardized rewards.
        baseline = (RunningBaseline()
                    if cfg.use_baseline and reward_norm != "pergraph"
                    else None)
        controller = pop = None
        if population is not None:
            # The population draws from its own generator, so the chain
            # streams — and a run without one — are untouched.
            controller = PopulationController(population, num_chains=nchains)
            pop = engine.init_population(
                population_generator(cfg.seed, self.device),
                num_chains=nchains)
        runner = EpisodeRunner(
            self, engine, pipeline=pipeline,
            tracker=BestTracker([a.num_nodes for a in arrays], nchains),
            reward_norm=reward_norm, baseline=baseline,
            controller=controller)
        return runner, WindowStream.fresh(engine, cfg.seed, nchains,
                                          self.device, pop=pop)

    def _run_episodes(self, runner: EpisodeRunner, stream: WindowStream,
                      verbose: bool) -> List[dict]:
        """``cfg.max_episodes`` episodes of ``runner`` → the history."""
        history: List[dict] = []
        for episode in range(self.cfg.max_episodes):
            history.append({"episode": episode,
                            **runner.run_episode(stream)})
            if verbose:
                h = history[-1]
                per_g = "/".join(f"{x * 1e3:.2f}" for x in h["per_graph_best"])
                print(f"ep {episode:3d} reward {h['mean_reward']:.4g} "
                      f"best[ms] {per_g} groups {h['mean_groups']:.1f} "
                      f"G={len(stream.z)} B={stream.z[0].shape[0]}")
        return history

    # ------------------------------------------------------- joint training
    def train_multi(self, graphs: List[CompGraph],
                    arrays: Optional[List[GraphArrays]] = None, *,
                    platform: Platform, verbose: bool = False,
                    feature_cfg: Optional[FeatureConfig] = None,
                    reward_norm: str = "pergraph",
                    population=None) -> MultiSearchResult:
        """Train ONE policy jointly over ``graphs`` (GDP/Placeto-style).

        Each episode samples one window of ``batch_chains`` chains on every
        graph, scores each graph's placements with the ``cfg.engine``
        backend (``"scan"`` for ``"auto"``/``"batched"``) and updates the
        shared policy once with the Eq.-14 gradient averaged over the G·B
        chains.

        ``reward_norm="pergraph"`` standardizes each graph's rewards within
        the window (in float64 over its (t, b) entries), so graphs of very
        different latency scales contribute comparably; it replaces
        ``cfg.use_baseline``'s EMA.  ``"none"`` keeps raw 1/latency rewards
        and the EMA: with one graph it is ``search`` draw for draw.

        Without ``arrays``, features come from ``feature_cfg`` or a
        :func:`shared_feature_config` spanning all graphs, stored on
        ``self.feature_config`` for held-out graphs.
        """
        cfg = self.cfg
        G = len(graphs)
        nchains = max(1, cfg.batch_chains)
        t_start = time.perf_counter()
        runner, stream, arrays = self.joint_runner(
            graphs, arrays, platform=platform, feature_cfg=feature_cfg,
            reward_norm=reward_norm, population=population)
        history = self._run_episodes(runner, stream, verbose)

        # Per-graph greedy decodes with the final shared policy.
        greedy_placements: List[np.ndarray] = []
        greedy_latencies = np.empty(G)
        for g in range(G):
            p = self.place(arrays[g], greedy=True).astype(np.int64)
            greedy_placements.append(p)
            greedy_latencies[g] = simulate(graphs[g], p, platform).latency

        wall = time.perf_counter() - t_start
        n_evals = cfg.max_episodes * cfg.update_timestep * G * nchains
        tracker = runner.tracker
        return MultiSearchResult(
            tracker.best_placements, tracker.best_latencies,
            greedy_placements, greedy_latencies, history, self.policy, wall,
            n_evals, n_evals / max(wall, 1e-9), tracker.chain_best)

    def joint_runner(self, graphs: List[CompGraph],
                     arrays: Optional[List[GraphArrays]] = None, *,
                     platform: Platform,
                     feature_cfg: Optional[FeatureConfig] = None,
                     reward_norm: str = "pergraph", population=None):
        """What ``train_multi`` runs its episodes with, after its checks →
        (``EpisodeRunner``, fresh ``WindowStream``, the graphs' arrays).
        Initializes the policy on the first graph if it has none."""
        cfg = self.cfg
        if not graphs:
            raise ValueError("train_multi needs at least one graph")
        if reward_norm not in ("none", "pergraph"):
            raise ValueError(f"unknown reward_norm {reward_norm!r}")
        if population is not None:
            population = _as_population(population)
        if cfg.num_devices > platform.num_devices:
            raise ValueError(
                f"cfg.num_devices={cfg.num_devices} exceeds the platform's "
                f"{platform.num_devices} devices")
        self.bind_platform(platform)
        if arrays is None:
            fc = feature_cfg or shared_feature_config(graphs)
            self.feature_config = fc
            arrays = [extract_features(g, fc) for g in graphs]
        elif feature_cfg is not None:
            self.feature_config = feature_cfg
        widths = sorted({a.x.shape[1] for a in arrays})
        if len(widths) > 1:
            raise ValueError(
                f"feature widths differ across graphs ({widths}); extract "
                f"all graphs with one shared_feature_config()")
        # cfg.engine names the reward backend; "auto"/"batched" mean scan.
        # The scalar loop has no multi-graph form.
        if cfg.engine == "scalar":
            raise ValueError(
                "train_multi has no scalar loop; use engine='auto' or a "
                f"simulator backend name {backend_names()}")
        pipeline = RewardPipeline.from_graphs(
            graphs, platform, backend=reward_backend(cfg.engine),
            device=self.device)
        runner, stream = self._runner(arrays, pipeline,
                                      reward_norm=reward_norm,
                                      population=population)
        return runner, stream, arrays

    # ------------------------------------------------------------- inference
    def place(self, arrays: GraphArrays,
              generator: Optional[torch.Generator] = None,
              greedy: bool = True) -> np.ndarray:
        """One forward placement with the current policy → (V,).

        ``greedy`` decodes the most likely placement without dropout;
        ``greedy=False`` samples one, its edge and parse dropout and Gumbel
        noise drawn from ``generator`` (default: a generator on the agent's
        device seeded 0).  The device head places on the bound fleet
        (``bind_platform``), with no capacity mask, as the reference's
        ``place`` does.
        """
        if self.policy is None:
            raise RuntimeError("call init(), load_params() or search() first")
        rollout = self.rollout_engine(arrays)
        streams = None
        if not greedy:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            streams = ChainStreams.of([generator])
        _, _, fines, _ = rollout.rollout_window(
            rollout.x0[None], num_steps=1, start_first=True,
            streams=streams, greedy=greedy)
        return fines[0, 0].cpu().numpy()


class MultiGraphTrainer(HSDAG):
    """Cross-graph trainer: one policy over several graphs.

    A thin facade over :meth:`HSDAG.train_multi` that pins the reward
    normalization, remembers the shared feature layout for held-out graphs,
    and adds zero-shot evaluation and checkpointing of the shared policy in
    the reference's format::

        trainer = MultiGraphTrainer(HSDAGConfig(batch_chains=8))
        res = trainer.train([inception_v3(), resnet50()],
                            platform=paper_platform())
        placement, latency = trainer.evaluate_zero_shot(
            bert_base(), platform=paper_platform())
        trainer.save_policy("ckpt/joint")
    """

    def __init__(self, cfg: HSDAGConfig = HSDAGConfig(), *,
                 reward_norm: str = "pergraph", device="cuda"):
        super().__init__(cfg, device=device)
        if reward_norm not in ("none", "pergraph"):
            raise ValueError(f"unknown reward_norm {reward_norm!r}")
        self.reward_norm = reward_norm

    def train(self, graphs: List[CompGraph],
              arrays: Optional[List[GraphArrays]] = None, *,
              platform: Platform, verbose: bool = False,
              feature_cfg: Optional[FeatureConfig] = None,
              population=None) -> MultiSearchResult:
        return self.train_multi(graphs, arrays, platform=platform,
                                verbose=verbose, feature_cfg=feature_cfg,
                                reward_norm=self.reward_norm,
                                population=population)

    def evaluate_zero_shot(self, graph: CompGraph, *, platform: Platform,
                           arrays: Optional[GraphArrays] = None
                           ) -> Tuple[np.ndarray, float]:
        """Greedy-decode an *unseen* graph with the trained shared policy →
        (placement, latency on the host scheduler).  The graph is featurized
        with the training run's shared feature config, so one-hot columns
        line up (op types the training graphs lack get all-zero columns)."""
        if self.policy is None:
            raise RuntimeError("train() first")
        if arrays is None:
            if self.feature_config is None:
                raise ValueError(
                    "no stored feature_config; pass arrays= extracted with "
                    "the training config")
            arrays = extract_features(graph, self.feature_config)
        p = self.place(arrays, greedy=True).astype(np.int64)
        return p, simulate(graph, p, platform).latency

    # ------------------------------------------------------------ checkpoint
    def save_policy(self, directory: str, step: int = 0,
                    meta: Optional[Dict] = None) -> None:
        """Atomically persist the shared policy and its feature layout in
        the reference's format (``step_%010d/state.npz`` +
        ``manifest.json``).  The manifest records the training config and
        the engine whose backend produced the rewards."""
        from ..checkpoint import save_policy
        if self.policy is None:
            raise RuntimeError("train() first")
        full_meta = dict(meta or {})
        full_meta.setdefault("engine", self.cfg.engine)
        full_meta.setdefault("config", dataclasses.asdict(self.cfg))
        save_policy(directory, self.policy, step=step,
                    feature_config=self.feature_config, meta=full_meta)

    def load_policy(self, directory: str,
                    step: Optional[int] = None) -> int:
        """Restore a saved shared policy (either package's) into this
        trainer.

        ``self.policy`` must already be initialized (``init()`` on any graph
        featurized with the same config) so the structure is known; every
        leaf must be in the checkpoint at its shape.  Restores the stored
        feature config onto ``self.feature_config``, resets the optimizer,
        and returns the restored step.
        """
        from ..checkpoint import restore_policy
        if self.policy is None:
            raise RuntimeError(
                "init() first (the checkpoint restores into the policy's "
                "structure)")
        tree, self.feature_config, step, manifest = restore_policy(
            directory, self.policy, step=step)
        recorded = manifest.get("engine")
        if recorded is not None and recorded not in (
                _LOOP_ENGINES + tuple(backend_names())):
            raise ValueError(
                f"checkpoint was trained with engine {recorded!r}, which is "
                f"not registered here; registered simulator backends: "
                f"{backend_names()}")
        self.load_params(tree)
        return step
