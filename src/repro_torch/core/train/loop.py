"""The window-granular REINFORCE episode loop over a (G, B) chain batch.

Port of ``repro/core/train/loop.py``.  One episode = one ``update_timestep``
rollout window of every graph's B chains (a
:class:`~repro_torch.core.sim.rollout.MultiRolloutEngine`), scored by a
multi-graph :class:`~repro_torch.core.sim.pipeline.RewardPipeline`, tracked
by a :class:`BestTracker`, and applied to the shared policy as one exact
Eq.-14 replay gradient.  ``HSDAG.train_multi`` drives one
:class:`EpisodeRunner` over a fixed set of graphs, and ``HSDAG.search``
one over its single graph.  The reference's
``EpisodePrefetcher`` serves its corpus trainer only, and comes with it
(ROADMAP.md 'Modules to port' item 6, the corpus half).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..reinforce import step_weights

__all__ = ["make_chain_streams", "WindowStream", "BestTracker",
           "EpisodeRunner", "window_weights"]


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
    windows.
    """

    z: List[torch.Tensor]         # G × (B, V_g, d) — window-start state
    streams: List[ChainStreams]   # G — each graph's chain streams
    first: bool                   # next window starts with the transform step
    pop: object = None            # Optional[ChainState]

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
    (and reduces to the single-graph search at G=1).
    """

    def __init__(self, num_nodes: Sequence[int], num_chains: int):
        self.num_nodes = [int(n) for n in num_nodes]
        n = len(self.num_nodes)
        self.best_latencies = np.full(n, np.inf)
        self.best_placements: List[np.ndarray] = [
            np.zeros(nn, dtype=np.int64) for nn in self.num_nodes]
        self.chain_best = np.full((n, num_chains), np.inf)

    def update(self, fines: Sequence[np.ndarray], rewards: np.ndarray,
               latencies: np.ndarray, baseline=None) -> None:
        """Fold a window in: one (T, B, V_g) placement array a graph and
        (T, G, B) rewards and latencies; the EMA ``baseline`` takes each
        reward."""
        T, G, B = latencies.shape
        for t in range(T):
            for g in range(G):
                for b in range(B):
                    if baseline is not None:
                        baseline.update(rewards[t, g, b])
                    if latencies[t, g, b] < self.best_latencies[g]:
                        self.best_latencies[g] = float(latencies[t, g, b])
                        self.best_placements[g] = \
                            fines[g][t, b].astype(np.int64)
        self.chain_best = np.minimum(self.chain_best, latencies.min(axis=0))


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
    ``pipeline`` a ``RewardPipeline`` over the same graphs.  ``controller``
    (a ``PopulationController``) runs the population's PBT rounds; it is
    needed when the stream carries a ``pop``.
    """

    def __init__(self, agent, engine, *, pipeline, tracker: BestTracker,
                 reward_norm: str = "none", baseline=None, controller=None):
        self.agent = agent
        self.engine = engine
        self.pipeline = pipeline
        self.tracker = tracker
        self.reward_norm = reward_norm
        self.baseline = baseline
        self.controller = controller

    def run_episode(self, stream: WindowStream, *,
                    noise: Optional[Sequence] = None) -> Dict:
        """One window of every graph; ``noise`` (one ``WindowNoise`` a
        graph) replaces the draws from ``stream.streams``."""
        agent, engine = self.agent, self.engine
        cfg = agent.cfg
        tsteps = cfg.update_timestep
        t_ep = time.perf_counter()

        pop = stream.pop
        z, records, fines, ngroups = engine.rollout_window(
            stream.z, num_steps=tsteps, start_first=stream.first,
            streams=None if noise is not None else stream.streams,
            noise=noise,
            temperature=pop.temperature if pop is not None else None)
        rewards, latencies = self.pipeline.score_window(fines)   # (T, G, B)
        pop_next = None
        if pop is not None:
            pop_next = engine.update_population(pop, engine.pad(fines),
                                                latencies)
        self.tracker.update([f.cpu().numpy() for f in fines], rewards,
                            latencies, self.baseline)

        # ---- shared-policy update over the (T, G, B) window ----
        weights = torch.as_tensor(
            window_weights(rewards, cfg, reward_norm=self.reward_norm,
                           baseline=self.baseline),
            device=stream.z[0].device)
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
            due, use_greedy = self.controller.note_window()
            if due:
                pop_next, stream.z = engine.pbt_step(
                    pop_next, stream.z, use_greedy=use_greedy)
            pop_stats = {
                "culled": bool(due),
                "pop_best_latency": float(pop_next.best_latency.min()),
                "temp_mean": float(pop_next.temperature.mean()),
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
