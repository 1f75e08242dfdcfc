"""Population search over the B chains — PBT culling, elite exchange, greedy
restarts.

Port of ``repro/core/train/population.py`` for ``search``,
``train_multi`` and the corpus trainer.  Three mechanisms, all standard
population-based-training moves specialised to placement search:

* **Culling** — every ``cull_every`` windows, rank the chains by their
  best-found makespan; the bottom ``cull_fraction`` resample their sampling
  temperature from a random elite's (top ``elite_fraction``) with a
  log-uniform perturbation, inherit the global-best record, and restart
  their rollout state from the global-best chain's.
* **Elite exchange** — an additional ``exchange_fraction`` of random
  non-elite chains inherit the global-best record (latency + placement)
  without being reset.
* **Greedy restarts** — every ``greedy_restart_every``-th cull round,
  culled chains re-seed from the current *greedy decode's* state instead of
  the best chain's.

The per-chain knob is the categorical sampling **temperature** (logits / T
before the Gumbel argmax); the replayed Eq.-14 gradient stays exact because
the replay runs the same tempered distribution.

As the reference's, :class:`ChainState` holds (G, B) rows of chains, one
row a graph (G=1 for the single-graph search).  :func:`pbt_rows` works on
such rows and takes its random draws as a :class:`PBTDraws`, so a test can
feed the reference's own.  At run time they come from one
``torch.Generator`` seeded from (``cfg.seed``, ``0x706F70``) apart from the
chains' streams, so a search without a population draws exactly what it
drew before.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..._device import seeded_generator

__all__ = ["PopulationConfig", "ChainState", "PBTDraws",
           "PopulationController", "chain_counts", "draw_pbt",
           "init_chain_state", "init_temperatures", "population_generator",
           "update_chain_bests", "pbt_rows"]

#: the stream the population's draws come from, beside ``cfg.seed``
#: (the reference folds the same constant into its key)
POPULATION_STREAM = 0x706F70


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    """Knobs of the population search layer — the reference's fields,
    validation and JSON form, so a config round-trips between the two
    packages."""

    #: windows between cull rounds (one training episode = one window).
    cull_every: int = 4
    #: fraction of chains culled each round.
    cull_fraction: float = 0.25
    #: fraction of chains that count as elites (donors / never culled).
    elite_fraction: float = 0.25
    #: fraction of random non-elite survivors that inherit the global-best
    #: record each round (exchange without reset).
    exchange_fraction: float = 0.25
    #: log-uniform temperature perturbation range [1/perturb, perturb].
    perturb: float = 1.25
    #: initial per-chain temperatures are log-uniform in [init_lo, init_hi].
    init_lo: float = 0.7
    init_hi: float = 1.5
    #: hard clip range temperatures may never leave.
    temp_min: float = 0.2
    temp_max: float = 3.0
    #: every k-th cull round restarts culled chains from the greedy decode
    #: instead of the best chain's state (0 = off).
    greedy_restart_every: int = 0
    #: seed for the episodic (host-side) controller's RNG.
    seed: int = 0

    def __post_init__(self):
        if self.cull_every < 1:
            raise ValueError("cull_every must be >= 1")
        if not 0.0 < self.cull_fraction < 1.0:
            raise ValueError("cull_fraction must be in (0, 1)")
        if not 0.0 < self.elite_fraction < 1.0:
            raise ValueError("elite_fraction must be in (0, 1)")
        if not 0.0 <= self.exchange_fraction <= 1.0:
            raise ValueError("exchange_fraction must be in [0, 1]")
        if self.perturb < 1.0:
            raise ValueError("perturb must be >= 1.0 (it is a ratio)")
        if not (0.0 < self.temp_min <= self.init_lo <= self.init_hi
                <= self.temp_max):
            raise ValueError(
                "need 0 < temp_min <= init_lo <= init_hi <= temp_max, got "
                f"temp_min={self.temp_min}, init_lo={self.init_lo}, "
                f"init_hi={self.init_hi}, temp_max={self.temp_max}")
        if self.greedy_restart_every < 0:
            raise ValueError("greedy_restart_every must be >= 0")

    def to_json(self) -> str:
        """Canonical JSON form (sorted keys) — ``from_json`` round-trips."""
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, doc: Union[str, Dict]) -> "PopulationConfig":
        """Inverse of :meth:`to_json`; unknown fields rejected by name."""
        data = json.loads(doc) if isinstance(doc, str) else dict(doc)
        if not isinstance(data, dict):
            raise ValueError(f"PopulationConfig JSON must be an object, "
                             f"got {type(data).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(
                f"unknown PopulationConfig fields {unknown}; known fields: "
                f"{sorted(known)}")
        return cls(**data)


def chain_counts(cfg: PopulationConfig, num_chains: int) -> Tuple[int, int]:
    """→ (n_elite, n_cull) for a B-chain row; both at least 1.

    Elites and culled chains must be disjoint, otherwise the global-best
    chain could be culled and the best makespan could rise.
    """
    B = int(num_chains)
    n_elite = max(1, int(B * cfg.elite_fraction))
    n_cull = max(1, int(B * cfg.cull_fraction))
    if n_elite + n_cull > B:
        raise ValueError(
            f"batch_chains={B} is too small for elite_fraction="
            f"{cfg.elite_fraction} + cull_fraction={cfg.cull_fraction} "
            f"(n_elite={n_elite} + n_cull={n_cull} > {B}) — grow the chain "
            f"batch or shrink the fractions")
    return n_elite, n_cull


class ChainState(NamedTuple):
    """Per-chain population state of the B chains of each of G graphs."""

    temperature: torch.Tensor    # (G, B) f32 — categorical sampling temp
    best_latency: torch.Tensor   # (G, B) f32 — best makespan each found
    best_fine: torch.Tensor      # (G, B, V) i64 — the placement that did it
    rng: torch.Generator         # the PBT decisions' stream


class PBTDraws(NamedTuple):
    """The random draws of one PBT round over R rows of B chains."""

    donor: torch.Tensor         # (R, B) i64 in [0, n_elite) — elite rank
    log_perturb: torch.Tensor   # (R, B) f32 in [-log perturb, log perturb)
    exchange: torch.Tensor      # (R, B) f32 in [0, 1)


def population_generator(seed: int, device) -> torch.Generator:
    """The population's generator on ``device``, seeded from (``seed``,
    ``POPULATION_STREAM``)."""
    return seeded_generator([seed, POPULATION_STREAM], device)


def init_temperatures(cfg: PopulationConfig, generator: torch.Generator,
                      shape) -> torch.Tensor:
    """Log-uniform initial temperatures in [init_lo, init_hi]."""
    lo, hi = float(np.log(cfg.init_lo)), float(np.log(cfg.init_hi))
    u = torch.rand(shape, generator=generator, device=generator.device)
    return torch.exp(lo + u * (hi - lo)).float()


def init_chain_state(cfg: PopulationConfig, generator: torch.Generator, *,
                     num_graphs: int, num_chains: int, num_nodes: int,
                     temperatures=None) -> ChainState:
    """Fresh population state for a (G, B) grid of chains over graphs
    padded to V nodes, on the generator's device; ``temperatures`` (B,) or
    (G, B) overrides the draw."""
    chain_counts(cfg, num_chains)           # validate B up front
    dev = generator.device
    rows = (int(num_graphs), int(num_chains))
    if temperatures is None:
        temp = init_temperatures(cfg, generator, rows)
    else:
        temp = torch.as_tensor(temperatures, dtype=torch.float32,
                               device=dev).expand(rows).clone()
    return ChainState(
        temperature=temp,
        best_latency=torch.full(rows, float("inf"), device=dev),
        best_fine=torch.zeros(*rows, int(num_nodes), dtype=torch.long,
                              device=dev),
        rng=generator)


def update_chain_bests(state: ChainState, fines: torch.Tensor,
                       latencies: torch.Tensor) -> ChainState:
    """Fold one window's (T, G, B, V) placements and (T, G, B) latencies
    into the per-chain records.  Strict-< so earlier bests win ties, and
    the first minimum over T, as ``jnp.argmin`` takes it."""
    lat = latencies.to(torch.float32)
    t_star = torch.argmin(lat, dim=0)                         # first minimum
    cand_lat = torch.gather(lat, 0, t_star[None])[0]
    idx = t_star[None, ..., None].expand(1, *fines.shape[1:])
    cand_fine = torch.gather(fines, 0, idx)[0]
    better = cand_lat < state.best_latency
    return state._replace(
        best_latency=torch.where(better, cand_lat, state.best_latency),
        best_fine=torch.where(better[..., None], cand_fine,
                              state.best_fine))


def draw_pbt(cfg: PopulationConfig, generator: torch.Generator,
             rows: int, num_chains: int) -> PBTDraws:
    """One PBT round's draws for ``rows`` rows of B chains."""
    n_elite, _ = chain_counts(cfg, num_chains)
    log_p = float(np.log(cfg.perturb))
    shape = (int(rows), int(num_chains))
    dev = generator.device
    donor = torch.randint(0, n_elite, shape, generator=generator, device=dev)
    u = torch.rand(shape, generator=generator, device=dev)
    exchange = torch.rand(shape, generator=generator, device=dev)
    return PBTDraws(donor, (2.0 * u - 1.0) * log_p, exchange)


def pbt_rows(cfg: PopulationConfig, draws: PBTDraws, lat_rows: torch.Tensor,
             temp_rows: torch.Tensor):
    """PBT decisions for (R, B) rows of chain latencies and temperatures.

    → ``(culled, inherit, new_temp, jstar)``: (R, B) masks and temperatures
    and ``jstar`` the (R,) best chain of each row.  Chains rank by best
    latency with ties in chain order (a stable sort, as ``jnp.argsort``),
    so rank 0 — an elite, never culled — keeps the row's best.
    """
    B = lat_rows.shape[-1]
    n_elite, n_cull = chain_counts(cfg, B)
    order = torch.argsort(lat_rows, dim=-1, stable=True)      # best first
    rank = torch.argsort(order, dim=-1, stable=True)          # rank of b
    jstar = order[:, 0]
    culled = rank >= B - n_cull
    donor = torch.gather(order, 1, draws.donor)
    factor = torch.exp(draws.log_perturb)
    resampled = torch.clamp(torch.gather(temp_rows, 1, donor) * factor,
                            cfg.temp_min, cfg.temp_max)
    new_temp = torch.where(culled, resampled, temp_rows)
    exch = (draws.exchange < cfg.exchange_fraction) & (rank >= n_elite) \
        & ~culled
    return culled, culled | exch, new_temp, jstar


class PopulationController:
    """Host-side cadence keeper (and episodic-mode temperature owner).

    Two modes, as the reference's:

    * ``in_jit_pbt=True`` (persistent streams: ``search``/``train_multi``):
      the controller only counts windows — :meth:`note_window` says when a
      cull round is due and whether it is a greedy-restart round; the state
      changes in the rollout engine's ``pbt_step``.
    * ``in_jit_pbt=False`` (the corpus trainer, where every episode is a
      fresh one-window stream over a resampled graph subset): chain
      identity lives only in the persistent (B,) ``temps`` vector, drawn
      from ``numpy.random.default_rng(cfg.seed)``; the controller
      accumulates per-chain scores from each episode's latencies (per-slot
      standardized, so graphs of different latency scales vote comparably)
      and culls the vector on the host every ``cull_every`` episodes with
      the same donor/perturb scheme.  Its draws and ``state_dict`` are the
      reference's bit for bit.
    """

    def __init__(self, cfg: PopulationConfig, *, num_chains: int,
                 in_jit_pbt: bool = True):
        self.cfg = cfg
        self.num_chains = int(num_chains)
        chain_counts(cfg, self.num_chains)  # fail fast on tiny B
        self.in_jit_pbt = bool(in_jit_pbt)
        self.windows_seen = 0
        self.rounds = 0
        self.culled_total = 0
        self._rng = np.random.default_rng(cfg.seed)
        self.temps: Optional[np.ndarray] = None
        if not self.in_jit_pbt:
            lo, hi = np.log(cfg.init_lo), np.log(cfg.init_hi)
            self.temps = np.exp(self._rng.uniform(
                lo, hi, size=self.num_chains)).astype(np.float32)
        self._score = np.zeros(self.num_chains)
        self._score_n = 0

    # ------------------------------------------------------ stream mode
    def note_window(self) -> Tuple[bool, bool]:
        """Count one window → (cull round due?, greedy-restart round?)."""
        self.windows_seen += 1
        due = self.windows_seen % self.cfg.cull_every == 0
        use_greedy = False
        if due:
            self.rounds += 1
            _, n_cull = chain_counts(self.cfg, self.num_chains)
            self.culled_total += n_cull
            use_greedy = (self.cfg.greedy_restart_every > 0
                          and self.rounds % self.cfg.greedy_restart_every
                          == 0)
        return due, use_greedy

    # ----------------------------------------------- episodic (corpus) mode
    def observe_episode(self, latencies) -> bool:
        """Fold one episode's (T, G, B) latencies into the chain scores;
        culls ``temps`` when a round comes due.  → True iff it culled."""
        if self.in_jit_pbt:
            raise RuntimeError("observe_episode is the episodic-mode hook; "
                               "stream-mode populations cull in the engine")
        lat_min = np.asarray(latencies, np.float64).min(axis=0)   # (G, B)
        mean = lat_min.mean(axis=1, keepdims=True)
        std = lat_min.std(axis=1, keepdims=True) + 1e-12
        self._score += (-(lat_min - mean) / std).mean(axis=0)     # (B,)
        self._score_n += 1
        self.windows_seen += 1
        if self.windows_seen % self.cfg.cull_every:
            return False
        self._cull_temps()
        return True

    def _cull_temps(self) -> None:
        cfg = self.cfg
        B = self.num_chains
        n_elite, n_cull = chain_counts(cfg, B)
        score = self._score / max(1, self._score_n)
        order = np.argsort(-score, kind="stable")    # best first
        elites, culled = order[:n_elite], order[B - n_cull:]
        log_p = np.log(cfg.perturb)
        for b in culled:
            donor = elites[self._rng.integers(n_elite)]
            factor = np.exp(self._rng.uniform(-log_p, log_p))
            self.temps[b] = np.clip(self.temps[donor] * factor,
                                    cfg.temp_min, cfg.temp_max)
        self._score[:] = 0.0
        self._score_n = 0
        self.rounds += 1
        self.culled_total += n_cull

    # ------------------------------------------------------------ transport
    def state_dict(self) -> Dict:
        """JSON-serialisable state under the reference's keys (checkpoint
        manifests, corpus resume)."""
        return {
            "windows_seen": self.windows_seen,
            "rounds": self.rounds,
            "culled_total": self.culled_total,
            "rng": self._rng.bit_generator.state,
            "temps": (None if self.temps is None
                      else [float(t) for t in self.temps]),
            "score": [float(s) for s in self._score],
            "score_n": self._score_n,
        }

    def load_state_dict(self, state: Dict) -> None:
        self.windows_seen = int(state["windows_seen"])
        self.rounds = int(state["rounds"])
        self.culled_total = int(state["culled_total"])
        self._rng.bit_generator.state = state["rng"]
        if state.get("temps") is not None:
            self.temps = np.asarray(state["temps"], np.float32)
        self._score = np.asarray(state["score"], np.float64)
        self._score_n = int(state["score_n"])

    def summary(self) -> Dict:
        return {"windows": self.windows_seen, "cull_rounds": self.rounds,
                "chains_culled": self.culled_total}
