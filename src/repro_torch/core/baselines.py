"""Baseline placement methods (paper §3.3).

Port of ``repro/core/baselines.py``:

1.  ``cpu_only`` / ``gpu_only`` — whole graph on one device.
2.  ``openvino_auto`` — the OpenVINO-CPU / OpenVINO-GPU rows: the AUTO plugin
    runs the preferred device and pays an arbitration overhead (Table 2 shows
    OpenVINO-X ≈ X-only within 2–15%); modeled as preference placement with a
    fixed arbitration factor.
3.  ``PlacetoBaseline`` — encoder-placer: GNN node embeddings → per-node
    device logits → one-shot sampling, REINFORCE on episode reward
    (Placeto [1] without its per-node MDP refinement, as reimplemented by the
    paper's authors).
4.  ``RNNBaseline`` — grouper-less seq2seq placer of Mirhoseini et al. [22]:
    LSTM over nodes in topological order with content attention, REINFORCE.
5.  ``dp_placement`` / ``hybrid_placement`` — the exact series-parallel DP
    of ``repro_torch.platforms.exact`` (provably optimal on contention-free
    SP graphs) and its hybrid mode (DP-refined linear segments around an RL
    core placement).

The learned baselines keep the reference's episode loop: each episode
samples ``samples_per_episode`` placements with fixed parameters, scores
them with the host ``reward_fn``, and takes one Adam step on the REINFORCE
loss of those placements.  Their parameters do not change within an
episode, so the port samples an episode's placements as S rows of one
batched pass (Gumbel-max on a ``torch.Generator`` seeded from the seed) and
replays the log-probabilities of the *recorded* placements for the update;
a test feeds the reference's placements through :meth:`_sample_episode`.
``init`` draws the reference's initial weights (``core/prng.py``).
Everything runs on ``device``, the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device, seeded_generator
from ..kernels.gcn_spmm import gcn_graph
from ..optim.adamw import Adam
from . import prng
from .features import GraphArrays
from .gnn import MLP, Encoder, encoder_init, mlp_init
from .graph import CompGraph
from .hsdag import SearchResult
from .reinforce import RunningBaseline

__all__ = ["cpu_only", "gpu_only", "openvino_auto",
           "BaselineConfig", "PlacetoBaseline", "RNNBaseline",
           "PlacetoModel", "RNNModel",
           "dp_placement", "hybrid_placement"]


def cpu_only(graph: CompGraph) -> np.ndarray:
    return np.zeros(graph.num_nodes, dtype=np.int64)


def gpu_only(graph: CompGraph) -> np.ndarray:
    return np.ones(graph.num_nodes, dtype=np.int64)


def dp_placement(graph: CompGraph, platform) -> Tuple[np.ndarray, float]:
    """Exact series-parallel DP placement → (placement, latency).

    Raises ``ValueError`` for graphs outside the two-terminal SP class —
    use :func:`hybrid_placement` there.  Optimal when no device's queue
    limit binds (see ``repro_torch.platforms.exact``).
    """
    from ..platforms import dp_optimal
    res = dp_optimal(graph, platform)
    if res is None:
        raise ValueError(
            f"graph {graph.name!r} is not two-terminal series-parallel — "
            f"the exact DP does not apply (hybrid_placement refines any "
            f"placement's linear segments instead)")
    return res.placement, res.latency


def hybrid_placement(graph: CompGraph, placement: np.ndarray,
                     platform) -> Tuple[np.ndarray, float]:
    """DP-refine the linear segments of an (RL-produced) placement.

    Never worse than the input placement; → (placement, latency)."""
    from ..platforms import hybrid_refine
    res = hybrid_refine(graph, np.asarray(placement), platform)
    return res.placement, res.latency


def openvino_auto(graph: CompGraph, preference: int,
                  arbitration_factor: float = 1.08
                  ) -> Tuple[np.ndarray, float]:
    """AUTO-plugin-style baseline: preferred device + arbitration overhead.

    Returns (placement, latency multiplier to apply to the measured latency).
    """
    placement = np.full(graph.num_nodes, preference, dtype=np.int64)
    return placement, arbitration_factor


# ------------------------------------------------------------------ learned
@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    num_devices: int = 2
    hidden: int = 128
    learning_rate: float = 1e-4
    episodes: int = 100
    samples_per_episode: int = 20
    entropy_coef: float = 0.0
    seed: int = 0


def _gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise: ``argmax(logits + g)`` is a categorical
    sample of ``softmax(logits)``."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


class _LearnedBaseline:
    """The episode loop both learned baselines share (see module
    docstring); a subclass provides ``_init_tree``, ``_model_from``,
    ``_prepare``, ``_sample_episode`` and ``_loss``."""

    label = "?"

    def __init__(self, cfg: BaselineConfig = BaselineConfig(), *,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model: Optional[nn.Module] = None
        self._opt: Optional[Adam] = None

    def init(self, arrays: GraphArrays, seed: Optional[int] = None
             ) -> nn.Module:
        """The reference's initial weights for ``seed`` (default
        ``cfg.seed``): its ``init`` on ``split(PRNGKey(seed))[1]``."""
        k = prng.split(prng.key(self.cfg.seed if seed is None
                                else int(seed)))[1]
        return self.load_params(self._init_tree(k, arrays.x.shape[1]))

    def load_params(self, tree: Dict) -> nn.Module:
        """Adopt a reference parameter tree (numpy leaves, (in, out))."""
        self.model = self._model_from(tree).to(self.device)
        self._opt = Adam(self.model.parameters(), self.cfg.learning_rate)
        return self.model

    def search(self, graph: CompGraph, arrays: GraphArrays,
               reward_fn: Callable[[np.ndarray], Tuple[float, float]],
               rng: Optional[int] = None,
               verbose: bool = False) -> SearchResult:
        """``cfg.episodes`` episodes → the best sampled placement.

        ``rng`` is the run's seed (default ``cfg.seed``): the reference's
        ``PRNGKey(rng)`` for the initial weights and the sampling
        generator's seed."""
        cfg = self.cfg
        t0 = time.perf_counter()
        seed = cfg.seed if rng is None else int(rng)
        if self.model is None:
            self.init(arrays, seed)
        # the baselines' own sampling stream ("bas"), apart from the search's
        gen = seeded_generator([seed, 0x626173], self.device)
        state = self._prepare(arrays)
        baseline = RunningBaseline()
        best_lat, best_p = float("inf"), cpu_only(graph)
        history: List[dict] = []
        for ep in range(cfg.episodes):
            placements = self._sample_episode(state, gen)
            rewards = []
            for p in placements:
                r, lat = reward_fn(p)
                rewards.append(r)
                if lat < best_lat:
                    best_lat, best_p = float(lat), p.copy()
            b = baseline.value if baseline.value is not None \
                else np.mean(rewards)
            adv = np.asarray(rewards, np.float32) - b
            for r in rewards:
                baseline.update(r)
            loss = self._loss(state, placements,
                              torch.as_tensor(np.asarray(adv, np.float32),
                                              device=self.device))
            grads = torch.autograd.grad(loss, list(self.model.parameters()))
            self._opt.update(grads)
            history.append({"episode": ep,
                            "mean_reward": float(np.mean(rewards)),
                            "best_latency": best_lat})
            if verbose:
                print(f"[{self.label}] ep {ep} mean_r {np.mean(rewards):.4g} "
                      f"best {best_lat:.6f}")
        return SearchResult(best_p, best_lat, history, self.model, {},
                            time.perf_counter() - t0)


# ------------------------------------------------------------------ Placeto
class PlacetoModel(nn.Module):
    """GCN encoder (2 + 2 layers) and an ``[h, h, D]`` head → per-node
    device logits."""

    def __init__(self, d_in: int, hidden: int, num_devices: int):
        super().__init__()
        self.enc = Encoder(d_in, hidden, layer_trans=2, layer_gnn=2)
        self.head = MLP([hidden, hidden, num_devices])

    def forward(self, x0: torch.Tensor, graph, keep: torch.Tensor
                ) -> torch.Tensor:
        """x0 (V, d), keep (1, E) → logits (V, D)."""
        return self.head(self.enc(x0[None], graph, keep))[0]


class PlacetoBaseline(_LearnedBaseline):
    """GNN encoder → per-node categorical placement (encoder-placer)."""

    label = "placeto"

    def _init_tree(self, key: np.ndarray, d_in: int) -> Dict:
        cfg = self.cfg
        k1, k2 = prng.split(key)
        return {"enc": encoder_init(k1, d_in, cfg.hidden, layer_trans=2,
                                    layer_gnn=2),
                "head": mlp_init(k2, [cfg.hidden, cfg.hidden,
                                      cfg.num_devices])}

    def _model_from(self, tree: Dict) -> nn.Module:
        from ..checkpoint.convert import placeto_from_numpy
        return placeto_from_numpy(tree)

    def _prepare(self, arrays: GraphArrays):
        graph = gcn_graph(arrays.edges, arrays.num_nodes, self.device)
        keep = torch.ones((1, graph.num_edges), dtype=torch.float32,
                          device=self.device)
        return (torch.as_tensor(arrays.x, device=self.device), graph, keep)

    def logits(self, state) -> torch.Tensor:
        return self.model(*state)

    @torch.no_grad()
    def _sample_episode(self, state, gen: torch.Generator) -> np.ndarray:
        """``samples_per_episode`` placements (S, V) int64 of one pass."""
        logits = self.logits(state)
        g = _gumbel(gen, (self.cfg.samples_per_episode,) + logits.shape,
                    self.device)
        return (logits[None] + g).argmax(-1).cpu().numpy().astype(np.int64)

    def log_probs(self, state, placements) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """(S,) summed log-probabilities of ``placements`` (S, V), and the
        policy's entropy."""
        logp_full = torch.log_softmax(self.logits(state), -1)
        p = torch.as_tensor(np.asarray(placements), device=self.device)
        logp = logp_full.gather(1, p.T).sum(0)
        ent = -(logp_full.exp() * logp_full).sum()
        return logp, ent

    def _loss(self, state, placements, adv: torch.Tensor) -> torch.Tensor:
        logp, ent = self.log_probs(state, placements)
        s = self.cfg.samples_per_episode
        return (-(logp * adv).sum() - s * self.cfg.entropy_coef * ent) / s


# --------------------------------------------------------------------- RNN
def _lstm_init(key: np.ndarray, d_in: int, d_h: int) -> Dict:
    """The reference's ``_lstm_init``: normal weights (in, 4h) scaled by
    1/sqrt(h), a zero bias."""
    k1, k2 = prng.split(key)
    scale = np.float32(1.0 / np.sqrt(d_h))
    return {"wx": prng.normal(k1, (d_in, 4 * d_h)) * scale,
            "wh": prng.normal(k2, (d_h, 4 * d_h)) * scale,
            "b": np.zeros(4 * d_h, np.float32)}


class LSTMCell(nn.Module):
    """The reference's LSTM cell: one bias, gates ``i, f, g, o`` and a
    forget offset of +1 (``sigmoid(f + 1)``); weights stored (4h, in) like
    ``nn.Linear``'s.

    A step is ``torch.lstm_cell`` with the offset as its second bias (0 on
    the ``i, g, o`` gates, 1 on ``f``): its pre-activation is the
    reference's ``x @ wx + h @ wh + b`` plus the offset, and on the card it
    is one fused elementwise kernel (forward and backward) after the two
    products, where the gates op by op would be a dozen launches a step.
    ``tests/test_torch_baselines.py`` holds it against the reference's
    ``_lstm_step``."""

    def __init__(self, d_in: int, d_h: int):
        super().__init__()
        self.wx = nn.Parameter(torch.empty(4 * d_h, d_in))
        self.wh = nn.Parameter(torch.empty(4 * d_h, d_h))
        self.b = nn.Parameter(torch.empty(4 * d_h))
        offset = torch.zeros(4 * d_h)
        offset[d_h:2 * d_h] = 1.0
        self.register_buffer("forget_offset", offset, persistent=False)

    def step(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, *,
             wx: Optional[torch.Tensor] = None,
             b: Optional[torch.Tensor] = None):
        """One step on rows ``x`` (rows, in) → (h, c); ``wx`` and ``b``
        replace the cell's own input weight and bias (the decoder passes
        the part of its input that changes from step to step, and folds the
        rest into the bias)."""
        return torch.lstm_cell(x, (h, c), self.wx if wx is None else wx,
                               self.wh, self.b if b is None else b,
                               self.forget_offset)


class RNNModel(nn.Module):
    """Seq2seq LSTM placer: an encoder LSTM over the nodes in topological
    order, content attention, a decoder LSTM fed the previous choice."""

    def __init__(self, d_in: int, hidden: int, num_devices: int):
        super().__init__()
        self.hidden, self.num_devices = hidden, num_devices
        self.enc = LSTMCell(d_in, hidden)
        self.dec = LSTMCell(hidden + num_devices, hidden)
        self.attn = MLP([hidden, hidden])
        self.head = MLP([2 * hidden, num_devices])
        self.register_buffer("eye", torch.eye(num_devices), persistent=False)

    def encode(self, x_seq: torch.Tensor) -> torch.Tensor:
        """x_seq (n, d) → encoder states (n, h); deterministic, so a pass
        runs it once for all its rows."""
        h = c = x_seq.new_zeros(1, self.hidden)
        states = []
        for t in range(x_seq.shape[0]):
            h, c = self.enc.step(x_seq[t:t + 1], h, c)
            states.append(h)
        return torch.cat(states)

    def decode(self, x_seq: torch.Tensor, rows: int, *,
               gumbel: Optional[torch.Tensor] = None,
               choices: Optional[torch.Tensor] = None):
        """``rows`` decodes over the nodes → (choices (rows, n) i64, logits
        (n, rows, D)).  Each step samples ``argmax(logits + gumbel[t])``,
        or takes ``choices[:, t]`` (teacher forcing: the replay)."""
        enc = self.encode(x_seq)
        keys = self.attn(enc)
        d_h, n = self.hidden, x_seq.shape[0]
        # The decoder's input is [enc_h, onehot(prev)]: the encoder state is
        # the same for every row, so its product with the input weight
        # joins the bias, one row a step; the one-hot goes through the
        # weight's last D columns.
        bias = torch.addmm(self.dec.b, enc, self.dec.wx[:, :d_h].T)
        wx_prev = self.dec.wx[:, d_h:]
        if choices is not None:
            prev_all = self.eye[choices.T[:-1]]          # (n - 1, rows, D)
        h = c = enc.new_zeros(rows, d_h)
        onehot = enc.new_zeros(rows, self.num_devices)
        out_choices, out_logits = [], []
        for t in range(n):
            attn = torch.softmax(h @ keys.T, -1)           # old h
            ctx = attn @ enc
            if t:
                onehot = prev_all[t - 1] if choices is not None \
                    else self.eye[prev]
            h, c = self.dec.step(onehot, h, c, wx=wx_prev, b=bias[t])
            logits = self.head(torch.cat([h, ctx], -1))
            if choices is None:
                prev = (logits + gumbel[t]).argmax(-1)
                out_choices.append(prev)
            out_logits.append(logits)
        picked = choices if choices is not None \
            else torch.stack(out_choices, 1)
        return picked, torch.stack(out_logits)


class RNNBaseline(_LearnedBaseline):
    """Seq2seq LSTM placer with content attention (Mirhoseini et al.
    2017)."""

    label = "rnn"

    def _init_tree(self, key: np.ndarray, d_in: int) -> Dict:
        cfg = self.cfg
        k1, k2, k3, k4 = prng.split(key, 4)
        return {"enc": _lstm_init(k1, d_in, cfg.hidden),
                "dec": _lstm_init(k2, cfg.hidden + cfg.num_devices,
                                  cfg.hidden),
                "attn": mlp_init(k3, [cfg.hidden, cfg.hidden]),
                "head": mlp_init(k4, [2 * cfg.hidden, cfg.num_devices])}

    def _model_from(self, tree: Dict) -> nn.Module:
        from ..checkpoint.convert import rnn_from_numpy
        return rnn_from_numpy(tree)

    def _prepare(self, arrays: GraphArrays):
        # Nodes fed in topological order (the RNN's sequence view of the
        # DAG); choices come out in that order and map back through it.
        order = np.argsort(arrays.topo_pos)
        return order, torch.as_tensor(arrays.x[order], device=self.device)

    @torch.no_grad()
    def _sample_episode(self, state, gen: torch.Generator) -> np.ndarray:
        order, x_seq = state
        s = self.cfg.samples_per_episode
        g = _gumbel(gen, (x_seq.shape[0], s, self.cfg.num_devices),
                    self.device)
        choices, _ = self.model.decode(x_seq, s, gumbel=g)
        placements = np.empty((s, len(order)), np.int64)
        placements[:, order] = choices.cpu().numpy()
        return placements

    def log_probs(self, state, placements) -> torch.Tensor:
        """(S,) summed log-probabilities of ``placements`` (S, V), decoded
        with the recorded choices."""
        order, x_seq = state
        choices = torch.as_tensor(np.asarray(placements)[:, order],
                                  device=self.device)
        _, logits = self.model.decode(x_seq, choices.shape[0],
                                      choices=choices)
        logp = torch.log_softmax(logits, -1).gather(
            2, choices.T[..., None])[..., 0]
        return logp.sum(0)

    def _loss(self, state, placements, adv: torch.Tensor) -> torch.Tensor:
        logp = self.log_probs(state, placements)
        return -(logp * adv).sum() / self.cfg.samples_per_episode
