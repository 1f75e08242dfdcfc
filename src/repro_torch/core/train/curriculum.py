"""CurriculumTrainer — ONE policy over a workload corpus of dozens of DAGs.

Port of ``repro/core/train/curriculum.py``.  Each episode a
:class:`~repro_torch.core.train.sampler.CurriculumSampler` draws
``graphs_per_episode`` graphs from one size bucket (``plan_buckets`` bounds
the bucket count; a bucket smaller than an episode repeats members, so a
graph may fill several slots), the episode's window runs over those slots
and the shared policy takes one Eq.-14 update over all of them.
:meth:`CurriculumTrainer.warm_start` fine-tunes from a saved policy
(feature layout checked against the new graphs first).

The reference pads each episode to its bucket's shape and passes it to its
jitted engine as an operand, so that it compiles once a bucket.  The port
compiles nothing, so it runs each slot unpadded (one
:class:`~repro_torch.core.sim.rollout.RolloutEngine` a slot in a
:class:`~repro_torch.core.sim.rollout.MultiRolloutEngine`, an unpadded
:class:`~repro_torch.core.sim.pipeline.RewardPipeline`), which computes
what the reference's padded slot computes.  The buckets still decide the
sampler's strata, the greedy decode's chunks and the width of the
population's best-placement record (:class:`BucketShape`).

Per-graph data is cached by corpus index, at most ``stream_cache`` graphs
at once in each cache: the host half (features, the reward backend's
tables; built on a worker thread by the :class:`EpisodePrefetcher` while
the previous episode runs) and the device half (``x0``, the
``GCNGraph``, the backend's tables on the card; built on the main thread).
Neither cache is keyed on graph identity and both drop an evicted graph
whole, so a :class:`~repro_torch.graphs.StreamingCorpus` holds only the
sampled subset and its cached neighbours.

Randomness.  ``train_corpus(rng=s)`` (an int; default ``cfg.seed``) stands
for the reference's ``PRNGKey(s)``: the initial weights are the
reference's ``init`` on ``split(PRNGKey(s))[1]`` (``core/prng.py``).  The
numpy draws are the reference's bit for bit — the sampler's (seeded with
``cfg.seed``), the episodic population's temperatures and culls, the
corpus and its fingerprint.  The episode's torch draws are a function of
(s, episode, slot, chain) alone: slot g, chain b of episode e draws from
``seeded_generator([s, CORPUS_STREAM, e, g, b])`` and the population state
of episode e from ``seeded_generator([s, POPULATION_STREAM, e])``, where the
reference folds the episode into its key.  So an interrupted run resumed
from a checkpoint replays the episode stream the uninterrupted run draws,
bit for bit on the CPU.

Checkpoints carry the corpus fingerprint, the sampler's RNG and plateau
state, the best tracker, the optimizer state, the episodic population and
the EMA baseline in the reference's format, so a corpus checkpoint of
either package resumes in the other.

``mesh_shape=(gm, bm)`` tiles each episode's (G, B) chain grid over a
("graphs", "chains") mesh of gm·bm ranks
(:class:`~repro_torch.core.sim.sharded.ShardedRolloutEngine`).  Every rank
runs the same ``train_corpus`` (``torchrun --nproc-per-node=gm·bm``, each
rank calling ``torch.distributed.init_process_group`` first): the host side
takes the same decisions on every rank, each rank rolls out, scores and
replays its tile and draws its chains from their global (slot, chain)
streams, and the gathered window keeps the tracker, sampler and population
equal on every rank.  Only rank 0 writes checkpoints and ``save_policy``;
the others wait at a barrier, and every rank restores.  Without a process
group only the 1×1 mesh exists, and it trains bit for bit like
``mesh_shape=None``.
"""
from __future__ import annotations

import collections
import time
from types import SimpleNamespace
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

from ..._device import seeded_generator
from ...kernels.gcn_spmm import GCNGraph, gcn_graph
from ..costmodel import Platform, plan_buckets, simulate
from ..features import (GraphArrays, check_feature_compat, extract_features,
                        shared_feature_config)
from ..graph import CompGraph
from ..hsdag import HSDAGConfig, MultiGraphTrainer, reward_backend
from ..reinforce import RunningBaseline
from ..sim import get_backend
from ..sim.pipeline import RewardPipeline
from ..sim.rollout import ChainStreams, MultiRolloutEngine
from ..sim.sharded import (LocalMesh, ShardedRolloutEngine,
                           make_rollout_mesh, rollout_tile)
from . import population as popmod
from .loop import BestTracker, EpisodePrefetcher, EpisodeRunner, WindowStream
from .sampler import CurriculumSampler

__all__ = ["CurriculumTrainer", "CorpusTrainResult", "BucketShape",
           "CORPUS_STREAM"]

#: the corpus episodes' stream, beside the seed ("corp")
CORPUS_STREAM = 0x636F7270


class BucketShape(NamedTuple):
    """The padded shape of one size bucket in the reference."""

    v_max: int       # node slots
    p_max: int       # predecessor slots (sim side)
    e_max: int       # edge slots (encoder side)


class CorpusTrainResult(NamedTuple):
    """Outcome of one curriculum run over a corpus of N graphs."""

    best_latencies: np.ndarray           # (N,) seconds (inf if never sampled)
    best_placements: List[np.ndarray]    # per graph: best sampled placement
    greedy_latencies: np.ndarray         # (N,) greedy decode after training
    greedy_placements: List[np.ndarray]
    history: List[dict]                  # per-episode stats (+bucket, graphs)
    params: object                       # the shared HSDAGPolicy
    wall_time_s: float
    num_evaluations: int
    evals_per_sec: float
    buckets: List[List[int]]             # the size partition used
    episodes_run: int


class _LRU:
    """``build(i)`` cached by corpus index, at most ``capacity`` entries,
    least-recently-used evicted first; ``peak`` is the most it held."""

    def __init__(self, build: Optional[Callable[[int], object]],
                 capacity: int):
        self._build = build
        self.capacity = int(capacity)
        self._lru: "collections.OrderedDict[int, object]" = \
            collections.OrderedDict()
        self.peak = 0

    def __call__(self, i: int):
        return self.get(i, lambda: self._build(i))

    def get(self, i: int, build: Callable[[], object]):
        """Entry ``i``, built by ``build()`` on a miss."""
        v = self._lru.get(i)
        if v is not None:
            self._lru.move_to_end(i)
            return v
        v = build()
        self._lru[i] = v
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)
        self.peak = max(self.peak, len(self._lru))
        return v

    def __len__(self) -> int:
        return len(self._lru)


class _HostSlot(NamedTuple):
    """One corpus graph's host data (numpy only)."""

    graph: CompGraph
    arrays: GraphArrays
    tables: object          # the reward backend's ``prepare_host``


class _Slot(NamedTuple):
    """One corpus graph's data on the agent's device."""

    x0: torch.Tensor
    graph: GCNGraph
    prep: object            # the reward backend's handle
    num_nodes: int


class CurriculumTrainer(MultiGraphTrainer):
    """See module docstring.  Example::

        corpus = build_corpus("benchmark;synthetic:family=mixed:count=9")
        trainer = CurriculumTrainer(HSDAGConfig(batch_chains=8),
                                    max_buckets=3, graphs_per_episode=4)
        res = trainer.train_corpus(corpus, platform=paper_platform(),
                                   checkpoint_dir="ckpt/corpus",
                                   checkpoint_every=10)
        trainer.save_policy("ckpt/corpus_policy")     # for warm starts

        ft = CurriculumTrainer(trainer.cfg)
        ft.warm_start("ckpt/corpus_policy")
        ft.train_corpus([held_out_graph], platform=paper_platform())

    ``update`` accepts the reference's ``"auto"``, ``"host"`` and
    ``"fused"`` with its validations.  ``"auto"`` takes the host's float64
    replay weights on every mesh: each rank already holds the window's
    gathered rewards on the host, so they cost no collective.  (The
    reference's ``"auto"`` takes its in-mesh float32 weights once the mesh
    is split, since there its rewards stay sharded on the device.)
    ``"fused"`` takes the sharded engine's in-mesh float32 weights; without
    a mesh the engine has none and every mode takes the host's, as in the
    reference.
    """

    def __init__(self, cfg: HSDAGConfig = HSDAGConfig(), *,
                 reward_norm: str = "pergraph", max_buckets: int = 4,
                 graphs_per_episode: int = 4,
                 sampler_strategy: str = "stratified",
                 plateau_patience: int = 5,
                 mesh_shape: Optional[Tuple[int, int]] = None,
                 update: str = "auto", stream_cache: int = 64,
                 population=None, prefetch: str = "auto", device="cuda"):
        super().__init__(cfg, reward_norm=reward_norm, device=device)
        if cfg.engine == "scalar":
            raise ValueError(
                "the corpus trainer has no scalar loop; use engine='auto' "
                "or a simulator backend name")
        if max_buckets < 1:
            raise ValueError("max_buckets must be >= 1")
        if update not in ("auto", "host", "fused"):
            raise ValueError(f"unknown update mode {update!r}; expected "
                             f"'auto', 'host' or 'fused'")
        if prefetch not in ("auto", "on", "off"):
            raise ValueError(f"unknown prefetch mode {prefetch!r}; expected "
                             f"'auto', 'on' or 'off'")
        if mesh_shape is not None:
            mesh_shape = (int(mesh_shape[0]), int(mesh_shape[1]))
            if min(mesh_shape) < 1:
                raise ValueError(f"mesh_shape must be positive, got "
                                 f"{mesh_shape}")
        if int(stream_cache) < 1:
            raise ValueError("stream_cache must be >= 1")
        if population is not None:
            if isinstance(population, dict):
                population = popmod.PopulationConfig.from_json(population)
            elif not isinstance(population, popmod.PopulationConfig):
                raise TypeError(
                    f"population= expects a PopulationConfig or its dict "
                    f"form, got {type(population).__name__}")
        self.max_buckets = int(max_buckets)
        self.graphs_per_episode = int(graphs_per_episode)
        self.sampler_strategy = sampler_strategy
        self.plateau_patience = int(plateau_patience)
        self.mesh_shape = mesh_shape
        #: the rollout mesh, built by the first ``train_corpus``
        self.mesh = None
        self.update = update
        self.stream_cache = int(stream_cache)
        self.population = population
        self.prefetch = prefetch
        self._warm_start: Optional[Tuple[str, Optional[int]]] = None
        #: the last run's prefetch hits and misses, and the most graphs its
        #: host and device caches held
        self.prefetch_stats: Dict[str, int] = {}
        self.cache_peaks: Dict[str, int] = {}

    # ------------------------------------------------------------ warm start
    def warm_start(self, directory: str, step: Optional[int] = None) -> None:
        """Fine-tune from a ``save_policy`` checkpoint (either package's).

        The restore happens inside :meth:`train_corpus`, where the new
        graphs are known: the saved feature layout is validated against
        them first (mismatched op vocabularies raise, naming the op types).
        """
        from ...checkpoint import policy_feature_config
        if policy_feature_config(directory, step) is None:
            raise ValueError(
                f"checkpoint {directory!r} carries no feature_config — it "
                f"cannot anchor a warm start (the new graphs could not be "
                f"featurized in the saved layout)")
        self._warm_start = (directory, step)

    def save_policy(self, directory: str, step: int = 0,
                    meta: Optional[Dict] = None) -> None:
        """:meth:`MultiGraphTrainer.save_policy`; on a mesh of several
        ranks rank 0 writes and the others wait for it."""
        if self._writer():
            super().save_policy(directory, step, meta)
        self._barrier()

    def _writer(self) -> bool:
        """Whether this rank writes files (rank 0 of a mesh's group)."""
        return not self._grouped() or dist.get_rank() == 0

    def _grouped(self) -> bool:
        return self.mesh is not None and not isinstance(self.mesh,
                                                          LocalMesh)

    def _barrier(self) -> None:
        if self._grouped():
            dist.barrier()

    # -------------------------------------------------------------- training
    def train_corpus(self, graphs: Sequence[CompGraph], *,
                     platform: Platform, rng: Optional[int] = None,
                     episodes: Optional[int] = None, verbose: bool = False,
                     checkpoint_dir: Optional[str] = None,
                     checkpoint_every: int = 0,
                     resume: bool = False) -> CorpusTrainResult:
        """Train the shared policy over ``graphs`` (the corpus).

        ``episodes`` overrides ``cfg.max_episodes``.  With
        ``checkpoint_dir``, state is saved every ``checkpoint_every``
        episodes (and at the end); ``resume=True`` continues an interrupted
        run from the latest checkpoint after validating that the corpus
        fingerprint matches.  ``graphs`` is a dense graph sequence or a
        :class:`~repro_torch.graphs.StreamingCorpus`.  ``rng`` is the
        run's seed (see module docstring).
        """
        from ...checkpoint import CheckpointManager
        cfg = self.cfg
        run = self._start(graphs, platform, rng)
        max_eps = episodes if episodes is not None else cfg.max_episodes
        mgr = (CheckpointManager(checkpoint_dir, keep=3)
               if checkpoint_dir else None)
        start_ep = 0
        if resume:
            if mgr is None:
                raise ValueError("resume=True requires checkpoint_dir")
            start_ep = self._resume(run, mgr)

        # Build episode t+1's host data on a worker thread while episode t
        # runs; "auto" enables it whenever an overlap can exist.
        prefetcher = None
        if self.prefetch == "on" or (self.prefetch == "auto"
                                     and max_eps - start_ep > 1):
            prefetcher = EpisodePrefetcher(
                lambda bi, ids: run.build_tile(ids))
        history: List[dict] = []
        try:
            for episode in range(start_ep, max_eps):
                bi, ids = run.sampler.sample()
                if prefetcher is not None:
                    payload, wait_s = prefetcher.get((bi, tuple(ids)))
                else:
                    t0 = time.perf_counter()
                    payload = run.build_tile(ids)
                    wait_s = time.perf_counter() - t0
                if prefetcher is not None and episode + 1 < max_eps:
                    nbi, nids = run.sampler.peek()
                    prefetcher.schedule((nbi, tuple(nids)))
                stats = self._episode(run, episode, bi, ids, payload)
                stats["batch_wait_s"] = wait_s
                run.sampler.observe(ids, run.tracker.best_latencies)
                history.append({"episode": episode, "bucket": bi,
                                "graphs": [run.meta[i].name for i in ids],
                                **stats})
                if verbose:
                    h = history[-1]
                    sampled = "/".join(
                        f"{run.tracker.best_latencies[i] * 1e3:.2f}"
                        for i in ids)
                    print(f"ep {episode:3d} bucket {bi} reward "
                          f"{h['mean_reward']:.4g} sampled-best[ms] "
                          f"{sampled} groups {h['mean_groups']:.1f}")
                if mgr is not None and checkpoint_every \
                        and (episode + 1) % checkpoint_every == 0:
                    self._save_state(mgr, episode, run)
        finally:
            if prefetcher is not None:
                self.prefetch_stats = {"hits": prefetcher.hits,
                                       "misses": prefetcher.misses}
                prefetcher.close()
            else:
                self.prefetch_stats = {"hits": 0, "misses": 0}
        if mgr is not None:
            if max_eps > start_ep:
                self._save_state(mgr, max_eps - 1, run)
            mgr.close()

        greedy_placements, greedy_latencies = self._greedy_corpus(run)
        self.cache_peaks = {"host": run.host.peak,
                            "device": run.slots.peak}
        wall = time.perf_counter() - run.t_start
        nchains = max(1, cfg.batch_chains)
        n_evals = max(0, max_eps - start_ep) * cfg.update_timestep \
            * run.g_sub * nchains
        return CorpusTrainResult(
            run.tracker.best_latencies, run.tracker.best_placements,
            greedy_latencies, greedy_placements, history, self.policy,
            wall, n_evals, n_evals / max(wall, 1e-9), run.buckets,
            max(0, max_eps - start_ep))

    # ------------------------------------------------------------ internals
    def _start(self, graphs, platform: Platform, rng) -> SimpleNamespace:
        """Everything a run needs before its first episode: features,
        initial (or warm-started) weights, buckets, sampler, tracker,
        population, caches and the runner."""
        from ...checkpoint import policy_feature_config, restore_policy
        from ...graphs.workloads import StreamingCorpus, corpus_fingerprint
        cfg = self.cfg
        t_start = time.perf_counter()
        streaming = isinstance(graphs, StreamingCorpus)
        if not streaming:
            graphs = list(graphs)
        # ``meta`` answers name/size/vocab for every graph without holding
        # it dense: the graphs of an eager corpus, the GraphMeta records of
        # a streaming one.
        meta: Sequence = graphs.meta if streaming else graphs
        if not len(meta):
            raise ValueError("train_corpus needs at least one graph")
        if cfg.num_devices > platform.num_devices:
            raise ValueError(
                f"cfg.num_devices={cfg.num_devices} exceeds the platform's "
                f"{platform.num_devices} devices")
        self.bind_platform(platform)
        nchains = max(1, cfg.batch_chains)
        g_sub = min(self.graphs_per_episode, len(meta))
        if self.mesh_shape is not None:
            gm, bm = self.mesh_shape
            if g_sub % gm:
                raise ValueError(
                    f"graphs_per_episode={g_sub} does not tile the mesh "
                    f"'graphs' axis ({gm}) — pick a multiple")
            if nchains % bm:
                raise ValueError(
                    f"batch_chains={nchains} does not tile the mesh "
                    f"'chains' axis ({bm}) — pick a multiple")
            if self.mesh is None:
                # before any tensor: on the card it picks this rank's device
                self.mesh = make_rollout_mesh(gm, bm, self.device.type)
        backend = get_backend(reward_backend(cfg.engine), device=self.device)

        # ---- feature layout: saved (warm start) or derived (fresh) ----
        if self._warm_start is not None:
            directory, wstep = self._warm_start
            fc = policy_feature_config(directory, wstep)
            check_feature_compat(fc, meta)
            self.feature_config = fc
        elif self.feature_config is not None:
            fc = self.feature_config
            check_feature_compat(fc, meta)
        else:
            fc = self.feature_config = shared_feature_config(meta)
        if streaming:
            # features rebuilt from the (itself LRU-cached) graph on a miss
            get_arrays = _LRU(lambda i: extract_features(graphs[i], fc),
                              self.stream_cache)
        else:
            arrays = [extract_features(g, fc) for g in graphs]
            get_arrays = arrays.__getitem__

        seed = cfg.seed if rng is None else int(rng)
        if self.policy is None:
            self.init(get_arrays(0), seed=seed)
        if self._warm_start is not None:
            tree, _, _, _ = restore_policy(directory, self.policy, step=wstep,
                                           graphs=meta)
            self.load_params(tree)
            self._warm_start = None

        sizes = [m.num_nodes for m in meta]
        buckets = plan_buckets(sizes, self.max_buckets)
        shapes = [BucketShape(
            v_max=max(meta[i].num_nodes for i in members),
            p_max=max(1, max(int(meta[i].in_degrees().max(initial=0))
                             for i in members)),
            e_max=max(1, max(int(meta[i].num_edges) for i in members)))
            for members in buckets]
        sampler = CurriculumSampler(
            buckets, graphs_per_episode=g_sub,
            strategy=self.sampler_strategy, seed=cfg.seed,
            plateau_patience=self.plateau_patience)
        # Episodic population: each episode is a fresh one-window stream
        # over a resampled subset, so chain identity lives in the
        # controller's persistent per-chain temperatures.
        controller = (popmod.PopulationController(
            self.population, num_chains=nchains, in_jit_pbt=False)
            if self.population is not None else None)
        tracker = BestTracker(sizes, nchains)
        baseline = (RunningBaseline()
                    if cfg.use_baseline and self.reward_norm != "pergraph"
                    else None)
        weights_mode = "fused" if self.update == "fused" else "host"
        if weights_mode == "fused":
            if baseline is not None:
                raise ValueError(
                    "update='fused' is incompatible with the EMA baseline "
                    "(its per-sample update is host-sequential); set "
                    "use_baseline=False or reward_norm='pergraph'")
            if not backend.fused:
                raise ValueError(
                    f"update='fused' needs a jit-fused simulator backend "
                    f"(rewards must already live on device); backend "
                    f"{backend.name!r} is host-side")
        runner = EpisodeRunner(self, None, pipeline=None, tracker=tracker,
                               reward_norm=self.reward_norm,
                               baseline=baseline, weights=weights_mode,
                               controller=controller)

        host = _LRU(lambda i: _HostSlot(
            graphs[i], get_arrays(i),
            backend.prepare_host(graphs[i], platform)), self.stream_cache)
        slots = _LRU(None, self.stream_cache)
        mesh = self.mesh if self.mesh_shape is not None else None

        def build(ids):
            """The host data of ``ids`` (unique, in slot order)."""
            return {i: host(i) for i in dict.fromkeys(ids)}

        return SimpleNamespace(
            graphs=graphs, meta=meta, streaming=streaming, platform=platform,
            backend=backend, seed=seed, t_start=t_start, buckets=buckets,
            shapes=shapes, g_sub=g_sub, sampler=sampler,
            controller=controller, tracker=tracker, baseline=baseline,
            runner=runner, host=host, slots=slots,
            fingerprint=corpus_fingerprint(graphs), mesh=mesh, build=build,
            # an episode's host data, of this rank's slots: what the
            # prefetcher's worker builds
            build_tile=lambda ids: build(
                ids if mesh is None else ids[rollout_tile(mesh, len(ids))[0]]))

    def _slot(self, run, i: int, hs: _HostSlot) -> _Slot:
        """Graph ``i``'s device data, from the device cache or built from
        its host data ``hs`` (main thread only)."""
        return run.slots.get(i, lambda: _Slot(
            torch.as_tensor(hs.arrays.x, device=self.device),
            gcn_graph(hs.arrays.edges, hs.arrays.num_nodes, self.device),
            run.backend.prepare_device(hs.graph, run.platform, hs.tables),
            int(hs.graph.num_nodes)))

    def _episode(self, run, episode: int, bi: int, ids: Sequence[int],
                 payload: Dict[int, _HostSlot], noise=None) -> Dict:
        """One episode over the slots ``ids`` of bucket ``bi``; ``noise``
        (one ``WindowNoise`` a slot) replaces the episode's draws."""
        engine, pipeline, stream = self._episode_parts(run, episode, bi, ids,
                                                       payload)
        return run.runner.run_episode(stream, noise=noise, engine=engine,
                                      pipeline=pipeline)

    def _engine(self, run, ids: Sequence[int], payload: Dict[int, _HostSlot],
                pipeline: bool = True):
        """The rollout engine over the slots ``ids`` (on a mesh, of this
        rank's tile of them) and, with ``pipeline``, its reward pipeline →
        (engine, pipeline or None)."""
        tile = ids if run.mesh is None else \
            ids[rollout_tile(run.mesh, len(ids))[0]]
        slots = [self._slot(run, i, payload[i]) for i in tile]
        scorer = None if not pipeline else RewardPipeline(
            backend=run.backend, preps=[s.prep for s in slots],
            num_nodes=[s.num_nodes for s in slots])
        engines = [self._engine_on(
            s.x0, s.graph, None if scorer is None else scorer.graph(g))
            for g, s in enumerate(slots)]
        if run.mesh is None:
            return MultiRolloutEngine(engines,
                                      population=self.population), scorer
        engine = ShardedRolloutEngine(
            engines, num_nodes=[run.meta[i].num_nodes for i in ids],
            mesh=run.mesh, population=self.population)
        return engine, None if scorer is None else \
            engine.tile_pipeline(scorer)

    def _episode_parts(self, run, episode: int, bi: int,
                       ids: Sequence[int], payload: Dict[int, _HostSlot]):
        """The engine, reward pipeline and fresh stream of one episode over
        the slots ``ids`` → (engine, pipeline, stream).  On a mesh the
        engine, the streams and the population are this rank's tile; the
        streams are those of the tile's global (slot, chain) ids."""
        nchains = max(1, self.cfg.batch_chains)
        engine, pipeline = self._engine(run, list(ids), payload)
        pop = None
        if run.controller is not None:
            pop = engine.init_population(
                seeded_generator([run.seed, popmod.POPULATION_STREAM,
                                  episode], self.device),
                num_chains=nchains, num_nodes=run.shapes[bi].v_max,
                temperatures=run.controller.temps)
        g_tile, b_tile = (slice(None), slice(None)) if run.mesh is None \
            else rollout_tile(run.mesh, len(ids), nchains)
        streams = [ChainStreams.of([
            seeded_generator([run.seed, CORPUS_STREAM, episode, g, b],
                             self.device) for b in range(nchains)[b_tile]])
            for g in range(len(ids))[g_tile]]
        stream = WindowStream(z=engine.initial_state(nchains),
                              streams=streams, first=True, pop=pop,
                              graph_ids=list(ids))
        return engine, pipeline, stream

    def _resume(self, run, mgr) -> int:
        """Restore the latest checkpoint of ``mgr`` into ``run`` → the
        episode to start from (0 when there is none)."""
        from ...checkpoint.convert import params_to_numpy
        last = mgr.latest_step()
        if last is None:
            return 0
        man = mgr.manifest(last)
        if man.get("corpus_fingerprint") != run.fingerprint:
            raise ValueError(
                "checkpoint was written for a different corpus "
                "(fingerprint mismatch) — resuming would mis-map "
                "sampler state and per-graph bests")
        saved_mesh = man.get("mesh")
        cur_mesh = (list(self.mesh_shape) if self.mesh_shape is not None
                    else None)
        # mesh=1×1 and unsharded are bit-for-bit the same run, so either
        # may resume the other; any real split changes the weights math
        # and must match exactly.
        if (saved_mesh or [1, 1]) != (cur_mesh or [1, 1]):
            raise ValueError(
                f"checkpoint was written with mesh={saved_mesh} but this "
                f"trainer uses mesh={cur_mesh} — a resumed run would not "
                f"replay the same episode stream; recreate the trainer with "
                f"the saved mesh_shape")
        names = [n for n, _ in self.policy.named_parameters()]
        state = mgr.restore(last, {"params": params_to_numpy(self.policy),
                                   "opt": self._opt.state_tree(names)})
        self.load_params(state["params"])
        self._opt.load_state_tree(state["opt"], names)
        run.sampler.load_state_dict(man["sampler"])
        run.tracker.load_state_arrays(
            {k: np.asarray(v) for k, v in man["tracker"].items()})
        saved_pop = man.get("population")
        if (saved_pop is None) != (run.controller is None):
            raise ValueError(
                "checkpoint population state does not match this "
                "trainer's population= setting — a resumed run "
                "would not replay the same temperature stream")
        if run.controller is not None:
            run.controller.load_state_dict(saved_pop)
        if run.baseline is not None:
            # the EMA feeds the step weights — without it a resumed run
            # would diverge from the uninterrupted one
            saved = man.get("baseline")
            if saved is None:
                raise ValueError(
                    "checkpoint carries no EMA-baseline state but "
                    "this config uses use_baseline — it was saved "
                    "by a run with a different reward setup")
            run.baseline.value = saved["value"]
            run.baseline.beta = saved["beta"]
        return int(man["episode"]) + 1

    def _greedy_corpus(self, run):
        """Greedy-decode every corpus graph, bucket by bucket in chunks of
        the episode width (on a streaming corpus each chunk materializes
        at most ``graphs_per_episode`` graphs); each latency is the host
        scheduler's.  On a mesh a short chunk is padded with its first
        graph to the episode width, so that it tiles the mesh, and each
        rank decodes its tile's real slots."""
        N = len(run.meta)
        placements: List[Optional[np.ndarray]] = [None] * N
        latencies = np.empty(N)
        for members in run.buckets:
            for lo in range(0, len(members), run.g_sub):
                chunk = members[lo:lo + run.g_sub]
                payload = run.build(chunk)
                if run.mesh is None:
                    engine, _ = self._engine(run, chunk, payload,
                                             pipeline=False)
                    fines = engine.greedy_decode()
                else:
                    engine, _ = self._engine(
                        run, chunk + [chunk[0]] * (run.g_sub - len(chunk)),
                        payload, pipeline=False)
                    fines = engine.greedy_decode(len(chunk))
                for gid, fine in zip(chunk, fines):
                    p = fine.cpu().numpy().astype(np.int64)
                    placements[gid] = p
                    latencies[gid] = simulate(payload[gid].graph, p,
                                              run.platform).latency
        return placements, latencies

    def _save_state(self, mgr, episode: int, run) -> None:
        from ...checkpoint.convert import params_to_numpy
        from ...checkpoint.manager import _feature_config_to_meta
        t = run.tracker.state_arrays()
        meta = {
            "episode": int(episode),
            "corpus_fingerprint": run.fingerprint,
            "sampler": run.sampler.state_dict(),
            "tracker": {"latencies": t["latencies"].tolist(),
                        "placements": t["placements"].tolist(),
                        "chain_best": t["chain_best"].tolist()},
            "engine": self.cfg.engine,
            "feature_config": _feature_config_to_meta(self.feature_config),
            "mesh": (list(self.mesh_shape)
                     if self.mesh_shape is not None else None),
            "stream": bool(run.streaming),
        }
        if run.baseline is not None:
            meta["baseline"] = {"value": run.baseline.value,
                                "beta": run.baseline.beta}
        if run.controller is not None:
            meta["population"] = run.controller.state_dict()
        names = [n for n, _ in self.policy.named_parameters()]
        if self._writer():
            mgr.save(episode, {"params": params_to_numpy(self.policy),
                               "opt": self._opt.state_tree(names)}, meta)
            mgr.wait()
        self._barrier()
