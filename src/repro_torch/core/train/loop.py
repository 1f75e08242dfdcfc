"""The window-granular REINFORCE episode loop over a (G, B) chain batch.

Port of ``repro/core/train/loop.py``.  One episode = one ``update_timestep``
rollout window of every graph's B chains (a
:class:`~repro_torch.core.sim.rollout.MultiRolloutEngine`), scored by a
multi-graph :class:`~repro_torch.core.sim.pipeline.RewardPipeline`, tracked
by a :class:`BestTracker`, and applied to the shared policy as one exact
Eq.-14 replay gradient.  ``HSDAG.train_multi`` drives one
:class:`EpisodeRunner` over a fixed set of graphs, ``HSDAG.search`` one
over its single graph, and the corpus trainer one over an engine and a
pipeline built anew for each episode's sampled slots (a slot may repeat a
graph), with :class:`EpisodePrefetcher` building the next episode's host
data while the current one runs.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..reinforce import step_weights

__all__ = ["make_chain_streams", "WindowStream", "BestTracker",
           "EpisodeRunner", "EpisodePrefetcher", "window_weights"]


def make_chain_streams(seed: int, num_graphs: int, num_chains: int,
                       device) -> List["ChainStreams"]:
    """The random streams of a (G, B) chain grid, one ``ChainStreams`` a
    graph.

    Graph 0 draws from ``[seed, b]``, the streams of the single-graph
    search, whatever G is; graph g > 0 draws from ``[seed, B + g, b]``, as
    the reference folds B + g into its key (``make_chain_rngs``).
    """
    # Imported here: the rollout module imports this package.
    from ..._device import seeded_generator
    from ..sim.rollout import ChainStreams
    streams = [ChainStreams(seed, num_chains, device)]
    for g in range(1, num_graphs):
        streams.append(ChainStreams.of([
            seeded_generator([seed, num_chains + g, b], device)
            for b in range(num_chains)]))
    return streams


@dataclasses.dataclass
class WindowStream:
    """Mutable rollout-stream state one runner episode advances.

    ``pop`` (a ``ChainState``, or ``None``: population search off) rides
    the stream so per-chain temperatures and best records persist across
    windows.  ``graph_ids`` maps the G slots to the tracker's graphs
    (``None``: slot g is graph g); the corpus trainer's slots may repeat a
    graph.
    """

    z: List[torch.Tensor]         # G × (B, V_g, d) — window-start state
    streams: List[ChainStreams]   # G — each graph's chain streams
    first: bool                   # next window starts with the transform step
    pop: object = None            # Optional[ChainState]
    graph_ids: Optional[Sequence[int]] = None

    @classmethod
    def fresh(cls, engine, seed: int, num_chains: int, device,
              pop=None) -> "WindowStream":
        return cls(z=engine.initial_state(num_chains),
                   streams=make_chain_streams(seed, engine.num_graphs,
                                              num_chains, device),
                   first=True, pop=pop)


class BestTracker:
    """Cumulative per-graph bests in the engine's (t, g, b) order.

    The order matters for reproducibility: the EMA baseline update
    interleaves with the strict-< best tie-break exactly as the reference's
    (and reduces to the single-graph search at G=1).  A window's G slots
    map to the tracked graphs through ``graph_ids``; a graph in several
    slots takes them in slot order.
    """

    def __init__(self, num_nodes: Sequence[int], num_chains: int):
        self.num_nodes = [int(n) for n in num_nodes]
        n = len(self.num_nodes)
        self.best_latencies = np.full(n, np.inf)
        self.best_placements: List[np.ndarray] = [
            np.zeros(nn, dtype=np.int64) for nn in self.num_nodes]
        self.chain_best = np.full((n, num_chains), np.inf)

    def update(self, fines: Sequence[np.ndarray], rewards: np.ndarray,
               latencies: np.ndarray, baseline=None,
               graph_ids: Optional[Sequence[int]] = None) -> None:
        """Fold a window in: one (T, B, V_g) placement array a slot and
        (T, G, B) rewards and latencies; the EMA ``baseline`` takes each
        reward.  ``graph_ids`` (default ``range(G)``) names each slot's
        graph."""
        T, G, B = latencies.shape
        ids = range(G) if graph_ids is None else [int(i) for i in graph_ids]
        for t in range(T):
            for g, gid in enumerate(ids):
                for b in range(B):
                    if baseline is not None:
                        baseline.update(rewards[t, g, b])
                    if latencies[t, g, b] < self.best_latencies[gid]:
                        self.best_latencies[gid] = float(latencies[t, g, b])
                        self.best_placements[gid] = \
                            fines[g][t, b].astype(np.int64)
        lat_min = latencies.min(axis=0)                          # (G, B)
        for g, gid in enumerate(ids):
            self.chain_best[gid] = np.minimum(self.chain_best[gid],
                                              lat_min[g])

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """Dense view for checkpointing (placements padded to the max V),
        the reference's."""
        vm = max(self.num_nodes) if self.num_nodes else 0
        plc = np.zeros((len(self.num_nodes), vm), np.int64)
        for i, p in enumerate(self.best_placements):
            plc[i, :p.shape[0]] = p
        return {"latencies": self.best_latencies.copy(),
                "placements": plc, "chain_best": self.chain_best.copy()}

    def load_state_arrays(self, state: Dict[str, np.ndarray]) -> None:
        self.best_latencies = np.asarray(state["latencies"]).copy()
        plc = np.asarray(state["placements"])
        self.best_placements = [plc[i, :n].astype(np.int64).copy()
                                for i, n in enumerate(self.num_nodes)]
        self.chain_best = np.asarray(state["chain_best"]).copy()


def window_weights(rewards: np.ndarray, cfg, *, reward_norm: str,
                   baseline=None) -> np.ndarray:
    """(T, G, B) rewards → (T, G, B) Eq.-14 step weights, float32.

    ``reward_norm="pergraph"`` standardizes each graph's rewards over its
    (t, b) window in float64 first; ``"none"`` keeps them raw, less the EMA
    ``baseline`` when one is given.
    """
    r = rewards
    if reward_norm == "pergraph":
        mean_g = rewards.mean(axis=(0, 2), keepdims=True)
        std_g = rewards.std(axis=(0, 2), keepdims=True)
        r = (rewards - mean_g) / (std_g + 1e-8)
    w_gbt = step_weights(
        np.transpose(r, (1, 2, 0)), cfg.gamma,
        reward_to_go=cfg.reward_to_go,
        baseline=(baseline.value if baseline is not None else None),
        normalize=cfg.normalize_weights)
    return np.ascontiguousarray(np.transpose(w_gbt, (2, 0, 1)))


class EpisodeRunner:
    """Runs one episode: rollout window → score → track → Eq.-14 update.

    ``agent`` supplies ``cfg`` and ``apply_grads`` (the optimizer step) —
    :class:`~repro_torch.core.hsdag.HSDAG`.  ``engine`` is a
    :class:`~repro_torch.core.sim.rollout.MultiRolloutEngine` and
    ``pipeline`` a ``RewardPipeline`` over the same graphs; the corpus
    trainer passes both to each :meth:`run_episode` instead.
    ``controller`` (a ``PopulationController``) runs the population's PBT
    rounds — in the engine (stream mode) or on its own temperature vector
    (episodic mode); it is needed when the stream carries a ``pop``.

    ``weights="fused"`` computes the replay weights with the engine's
    ``window_weights`` (float32, the per-graph standardization summed over
    the mesh's "chains" axis) from the float32 rewards on the device,
    instead of the host's float64 :func:`window_weights` (the corpus
    trainer's ``update="fused"``).  It needs a fused
    pipeline (the ``scan`` reward), an engine with ``window_weights`` and no
    EMA baseline (its update is host-sequential); the runner falls back to
    the host weights when any of these is missing, as the reference does.
    """

    def __init__(self, agent, engine, *, pipeline, tracker: BestTracker,
                 reward_norm: str = "none", baseline=None,
                 weights: str = "host", controller=None):
        if weights not in ("host", "fused"):
            raise ValueError(f"unknown weights mode {weights!r}; expected "
                             f"'host' or 'fused'")
        self.agent = agent
        self.engine = engine
        self.pipeline = pipeline
        self.tracker = tracker
        self.reward_norm = reward_norm
        self.baseline = baseline
        self.weights_mode = weights
        self.controller = controller

    def run_episode(self, stream: WindowStream, *,
                    noise: Optional[Sequence] = None, engine=None,
                    pipeline=None) -> Dict:
        """One window of every graph; ``noise`` (one ``WindowNoise`` a
        graph) replaces the draws from ``stream.streams``; ``engine`` and
        ``pipeline`` replace the runner's own for this episode."""
        agent = self.agent
        engine = engine if engine is not None else self.engine
        pipeline = pipeline if pipeline is not None else self.pipeline
        cfg = agent.cfg
        tsteps = cfg.update_timestep
        t_ep = time.perf_counter()

        pop = stream.pop
        z, records, fines, ngroups = engine.rollout_window(
            stream.z, num_steps=tsteps, start_first=stream.first,
            streams=None if noise is not None else stream.streams,
            noise=noise,
            temperature=pop.temperature if pop is not None else None)
        rewards, latencies = pipeline.score_window(fines)        # (T, G, B)
        pop_next = None
        if pop is not None:
            pop_next = engine.update_population(
                pop, engine.pad(fines, pop.best_fine.shape[-1]), latencies)
        self.tracker.update([f.cpu().numpy() for f in fines], rewards,
                            latencies, self.baseline, stream.graph_ids)

        # ---- shared-policy update over the (T, G, B) window ----
        device = stream.z[0].device
        if (self.weights_mode == "fused" and pipeline.fused
                and self.baseline is None
                and hasattr(engine, "window_weights")):
            # the backend scored in float32: the cast back is exact
            weights = engine.window_weights(
                torch.as_tensor(rewards, dtype=torch.float32, device=device),
                gamma=cfg.gamma, reward_to_go=cfg.reward_to_go,
                normalize=cfg.normalize_weights,
                reward_norm=self.reward_norm)
        else:
            weights = torch.as_tensor(
                window_weights(rewards, cfg, reward_norm=self.reward_norm,
                               baseline=self.baseline), device=device)
        for epoch in range(max(1, cfg.k_epochs)):
            # Epochs ≥ 2 replay the window's draws under the updated
            # weights, as the reference replays its keys.
            agent.apply_grads(engine.window_grads(
                stream.z, records, weights, start_first=stream.first,
                rederive=epoch > 0))

        # next window resumes from the post-rollout state
        stream.z = z
        stream.first = False

        # ---- population bookkeeping (after the update: the replay above
        # must see the temperatures the window sampled at) ----
        pop_stats: Dict = {}
        if pop_next is not None:
            ctl = self.controller
            if ctl.in_jit_pbt:
                due, use_greedy = ctl.note_window()
                if due:
                    pop_next, stream.z = engine.pbt_step(
                        pop_next, stream.z, use_greedy=use_greedy)
            else:
                due = ctl.observe_episode(latencies)
            # a sharded engine's state is its tile: report the grid's
            view = (engine.gather_population(pop_next)
                    if hasattr(engine, "gather_population") else pop_next)
            pop_stats = {
                "culled": bool(due),
                "pop_best_latency": float(view.best_latency.min()),
                "temp_mean": float(view.temperature.mean()),
            }
            stream.pop = pop_next

        return {
            "mean_reward": float(np.mean(rewards)),
            "best_latency": float(self.tracker.best_latencies.min()),
            "per_graph_best": [float(x) for x in self.tracker.best_latencies],
            "mean_groups": float(ngroups.double().mean()),
            "wall_s": time.perf_counter() - t_ep,
            **pop_stats,
        }


class EpisodePrefetcher:
    """Overlap host batch assembly of episode t+1 with device work of t.

    One background worker, one-slot request/response queues: the trainer
    predicts the next episode's (bucket, graph ids) key, :meth:`schedule`\\ s
    it, runs the current episode, then :meth:`get`\\ s the built payload.
    The build is host work only (features, tables, numpy arrays): tensors
    go to the device on the main thread, so no CUDA work races the
    episode.  Batch construction is deterministic in the key, so a
    prefetched payload is bitwise the synchronously-built one; a
    mispredicted key (the plateau sampler may re-weight between peek and
    draw) falls back to a synchronous build.  The worker touches the
    trainer's host caches only while the main thread is not building
    (``get`` always drains the in-flight build before building
    synchronously), so they need no lock.

    :meth:`get` returns ``(payload, wait_s)`` — ``wait_s`` is the main
    thread's stall (queue wait + any fallback build).  :meth:`close` is
    idempotent and joins the worker.
    """

    def __init__(self, build, *, name: str = "episode-prefetch"):
        self._build = build
        self._req: "queue.Queue" = queue.Queue(maxsize=1)
        self._res: "queue.Queue" = queue.Queue(maxsize=1)
        self._pending = None
        self.hits = 0
        self.misses = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    def _run(self):
        while True:
            key = self._req.get()
            if key is None:
                return
            try:
                self._res.put((key, self._build(*key), None))
            except BaseException as exc:  # surfaced on the main thread
                self._res.put((key, None, exc))

    def schedule(self, key) -> None:
        """Ask the worker to build ``key``; no-op if one is in flight."""
        if self._thread is None or self._pending is not None:
            return
        self._pending = key
        self._req.put(key)

    def get(self, key):
        """→ ``(payload, wait_s)`` for ``key`` (prefetched or fallback)."""
        t0 = time.perf_counter()
        payload = None
        if self._pending is not None:
            built_key, built, err = self._res.get()
            self._pending = None
            if err is not None:
                raise err
            if built_key == key:
                self.hits += 1
                payload = built
            else:
                self.misses += 1
        if payload is None:
            payload = self._build(*key)
        return payload, time.perf_counter() - t0

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def close(self) -> None:
        if self._thread is None:
            return
        if self._pending is not None:
            self._res.get()          # unblock a worker mid-put
            self._pending = None
        self._req.put(None)
        self._thread.join()
        self._thread = None
