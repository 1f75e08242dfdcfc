"""PlacementSession — the one object that owns a placement policy.

Port of ``repro/api/session.py``.  ``fit(spec)`` dispatches a
:class:`~repro_torch.api.PlacementSpec` to the right trainer (``search`` →
:class:`~repro_torch.core.HSDAG`, ``multi`` →
:class:`~repro_torch.core.MultiGraphTrainer`, ``corpus`` →
:class:`~repro_torch.core.CurriculumTrainer`) with the reference's argument
checks; the facade adds no numerics, only a stable surface.  After (or
instead of) fitting, the session owns the policy, the feature layout and the
platform — the three things a placement decision needs — and exposes:

* :meth:`place` / :meth:`evaluate` — greedy-decode a graph (feature
  vocabularies validated first via ``check_feature_compat``, so an
  out-of-vocabulary graph raises by op-type name instead of silently
  mis-encoding).
* :meth:`save` / :meth:`load` — persist/restore policy + feature layout +
  the full spec document in the reference's checkpoint format; the manifest
  records ``spec_hash`` and the corpus fingerprint, so a checkpoint names
  its run end-to-end, and either package's session loads the other's.

``rng=`` is the run's seed (an int, as ``train_corpus(rng=s)`` takes it):
the seed the reference's ``PRNGKey(s)`` would give.  The session runs on
``device``, the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..core.costmodel import Platform, simulate
from ..core.features import (FeatureConfig, GraphArrays, check_feature_compat,
                             extract_features, shared_feature_config)
from ..core.graph import CompGraph
from ..core.hsdag import HSDAG, MultiGraphTrainer
from ..core.train.curriculum import CurriculumTrainer
from ..graphs.workloads import (StreamingCorpus, build_corpus,
                                corpus_fingerprint)
from .spec import PlacementSpec, build_platform

__all__ = ["PlacementSession"]


class PlacementSession:
    """See module docstring.  Example::

        spec = PlacementSpec(workload="benchmark:names=bert_base",
                             mode="search",
                             config=HSDAGConfig(batch_chains=8))
        session = PlacementSession(spec)
        session.fit()
        placement, latency = session.evaluate(bert_base())
        session.save("ckpt/bert_policy")
        ...
        session = PlacementSession.load("ckpt/bert_policy")
    """

    def __init__(self, spec: Optional[PlacementSpec] = None, *,
                 device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.trainer: Optional[HSDAG] = None
        self.platform: Optional[Platform] = None
        self.graphs: List[CompGraph] = []
        self.result = None

    # ------------------------------------------------------------ properties
    @property
    def params(self):
        return self.trainer.policy if self.trainer is not None else None

    @property
    def feature_config(self) -> Optional[FeatureConfig]:
        return (self.trainer.feature_config
                if self.trainer is not None else None)

    def _corpus_trainer(self, spec: PlacementSpec, cfg) -> CurriculumTrainer:
        return CurriculumTrainer(
            cfg, reward_norm=spec.reward_norm,
            max_buckets=spec.max_buckets,
            graphs_per_episode=spec.graphs_per_episode,
            sampler_strategy=spec.sampler,
            plateau_patience=spec.plateau_patience,
            mesh_shape=tuple(spec.mesh) if spec.mesh else None,
            population=spec.population, prefetch=spec.prefetch,
            device=self.device)

    # ----------------------------------------------------------------- fit
    def fit(self, spec: Optional[PlacementSpec] = None, *,
            graphs: Optional[Sequence[CompGraph]] = None,
            arrays: Optional[Sequence[GraphArrays]] = None,
            platform: Optional[Platform] = None,
            reward_fn: Optional[Callable] = None,
            rng: Optional[int] = None, verbose: bool = False,
            resume: bool = False):
        """Train per ``spec`` and return the underlying trainer's result
        (``SearchResult`` / ``MultiSearchResult`` / ``CorpusTrainResult``).

        ``graphs``/``platform`` override the spec's workload/platform
        materialization for callers holding in-process objects (the
        benchmark drivers); ``arrays`` optionally rides along with
        pre-extracted features, and ``reward_fn`` (search mode only) swaps
        the simulator for a host callable (the ``MeasuredExecutor`` slot).
        When all of them are omitted the spec fully names the run.
        """
        spec = spec if spec is not None else self.spec
        if spec is None:
            raise ValueError("no spec: pass one to fit() or the constructor")
        self.spec = spec
        if graphs is None:
            if not spec.workload:
                raise ValueError(
                    "spec.workload is empty — pass graphs= explicitly or "
                    "give the spec a corpus spec string")
            graphs = build_corpus(spec.workload,
                                  stream=True if spec.stream else None)
        if not isinstance(graphs, StreamingCorpus):
            graphs = list(graphs)
        elif spec.mode != "corpus":
            raise ValueError(
                f"a streaming corpus only applies to mode='corpus' (got "
                f"mode={spec.mode!r}) — search/multi need dense graphs")
        if arrays is not None and len(arrays) != len(graphs):
            raise ValueError(f"got {len(arrays)} arrays for {len(graphs)} "
                             f"graphs")
        if reward_fn is not None and spec.mode != "search":
            raise ValueError("reward_fn= only applies to mode='search' "
                             "(multi/corpus rewards come from the "
                             "simulator backend)")
        if arrays is not None and spec.mode == "corpus":
            raise ValueError(
                "arrays= does not apply to mode='corpus': the curriculum "
                "trainer derives features per bucket itself (silently "
                "dropping pre-extracted arrays would train under a "
                "different layout than the caller supplied)")
        self.platform = (platform if platform is not None
                         else build_platform(spec))
        self.graphs = graphs
        cfg = spec.resolved_config()
        base = spec.feature_base()
        # search and multi take the run's seed through the config, as the
        # reference's PRNGKey(rng) replaces PRNGKey(cfg.seed)
        seeded = cfg if rng is None else dataclasses.replace(cfg,
                                                             seed=int(rng))

        if spec.mode == "search":
            if len(graphs) != 1:
                raise ValueError(
                    f"mode='search' needs exactly one graph; the workload "
                    f"materialized {len(graphs)} — use mode='multi' or "
                    f"'corpus', or narrow the workload spec")
            graph = graphs[0]
            fc = shared_feature_config(graphs, base=base)
            arr = arrays[0] if arrays is not None \
                else extract_features(graph, fc)
            agent = HSDAG(seeded, device=self.device)
            result = agent.search(
                graph, arr,
                reward_fn=reward_fn,
                platform=self.platform if reward_fn is None else None,
                verbose=verbose, population=spec.population)
            agent.feature_config = fc
            self.trainer = agent
        elif spec.mode == "multi":
            trainer = MultiGraphTrainer(seeded, reward_norm=spec.reward_norm,
                                        device=self.device)
            feature_cfg = (shared_feature_config(graphs, base=base)
                           if spec.feature else None)
            result = trainer.train(graphs, list(arrays) if arrays else None,
                                   platform=self.platform, verbose=verbose,
                                   feature_cfg=feature_cfg,
                                   population=spec.population)
            self.trainer = trainer
        else:                                   # corpus
            trainer = self._corpus_trainer(spec, cfg)
            if spec.warm_start:
                trainer.warm_start(spec.warm_start)
            elif spec.feature:
                vocab_src = (graphs.meta
                             if isinstance(graphs, StreamingCorpus)
                             else graphs)
                trainer.feature_config = shared_feature_config(vocab_src,
                                                               base=base)
            result = trainer.train_corpus(
                graphs, platform=self.platform, rng=rng, verbose=verbose,
                checkpoint_dir=spec.checkpoint_dir,
                checkpoint_every=spec.checkpoint_every, resume=resume)
            self.trainer = trainer
        self.result = result
        return result

    # ------------------------------------------------------------- inference
    def _require_fit(self) -> None:
        if self.trainer is None or self.trainer.policy is None:
            raise ValueError("session has no trained policy: call fit() "
                             "or load() first")

    def featurize(self, graph: CompGraph) -> GraphArrays:
        """Extract features in the session's trained layout (validated)."""
        self._require_fit()
        fc = self.feature_config
        if fc is None:
            raise ValueError("session carries no feature layout")
        check_feature_compat(fc, [graph])
        return extract_features(graph, fc)

    def place(self, graph: CompGraph, *, greedy: bool = True,
              generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Greedy-decode one placement for ``graph`` with the owned policy
        (``greedy=False`` samples one from ``generator``)."""
        arrays = self.featurize(graph)
        return self.trainer.place(arrays, generator=generator,
                                  greedy=greedy).astype(np.int64)

    def evaluate(self, graph: CompGraph, *, greedy: bool = True,
                 generator: Optional[torch.Generator] = None):
        """→ (placement, simulated latency seconds) on the session's
        platform."""
        p = self.place(graph, greedy=greedy, generator=generator)
        if self.platform is None:
            self.platform = build_platform(self.spec)
        return p, simulate(graph, p, self.platform).latency

    # ------------------------------------------------------------ checkpoint
    def save(self, directory: str, step: int = 0) -> None:
        """Persist policy + feature layout + the full spec document.

        The manifest records ``placement_spec`` (the canonical JSON),
        ``spec_hash`` and the corpus fingerprint of the graphs the session
        was fit on, so the checkpoint names its run end-to-end and
        :meth:`load` can rebuild the session without side information.
        """
        from ..checkpoint import save_policy
        self._require_fit()
        cfg = self.spec.resolved_config()
        meta = {
            "placement_spec": json.loads(self.spec.to_json()),
            "spec_hash": self.spec.spec_hash(),
            "engine": cfg.engine,
            "config": dataclasses.asdict(cfg),
        }
        if self.graphs:
            meta["corpus_fingerprint"] = corpus_fingerprint(self.graphs)
        if isinstance(self.trainer, CurriculumTrainer):
            # the same files; on a mesh of several ranks rank 0 writes them
            # and the others wait
            self.trainer.save_policy(directory, step, meta)
            return
        save_policy(directory, self.trainer.policy, step=step,
                    feature_config=self.feature_config, meta=meta)

    @classmethod
    def load(cls, directory: str, step: Optional[int] = None, *,
             graphs: Optional[Sequence[CompGraph]] = None,
             device="cuda") -> "PlacementSession":
        """Rebuild a session from a :meth:`save` checkpoint (either
        package's).

        The spec document in the manifest reconstructs the trainer; the
        saved feature layout shapes the parameter restore (via a tiny
        probe graph — the training corpus is *not* rebuilt, so loading a
        policy trained on a heavy workload stays cheap; per-request vocab
        validation happens in :meth:`featurize` anyway).  Pass ``graphs``
        to validate the saved vocabularies against a known graph set up
        front and keep it on ``session.graphs``.
        """
        from ..checkpoint import (policy_feature_config, policy_manifest,
                                  restore_policy)
        manifest = policy_manifest(directory, step)
        spec_doc = manifest.get("placement_spec")
        if spec_doc is None:
            raise ValueError(
                f"checkpoint {directory!r} carries no placement_spec — it "
                f"was not written by PlacementSession.save(); restore it "
                f"with repro_torch.checkpoint.restore_policy instead")
        spec = PlacementSpec.from_json(spec_doc)
        session = cls(spec, device=device)
        graphs = list(graphs) if graphs is not None else []
        cfg = spec.resolved_config()
        if spec.mode == "search":
            trainer = HSDAG(cfg, device=session.device)
        elif spec.mode == "multi":
            trainer = MultiGraphTrainer(cfg, reward_norm=spec.reward_norm,
                                        device=session.device)
        else:
            trainer = session._corpus_trainer(spec, cfg)
        fc = policy_feature_config(directory, step)
        if fc is None:
            raise ValueError(
                f"checkpoint {directory!r} carries no feature_config — "
                f"graphs could not be featurized in the trained layout")
        # Feature width is a function of the layout alone (vocab sizes +
        # fixed-width blocks), so any graph featurized under fc yields the
        # same parameter shapes — a 2-node probe is enough.
        probe_op = fc.op_vocab[0] if fc.op_vocab else "Parameter"
        probe = CompGraph("_load_probe")
        probe.add_op("a", probe_op, output_shape=(1,), flops=0, bytes_out=0)
        probe.add_op("b", probe_op, ["a"], (1,), flops=0, bytes_out=0)
        trainer.init(extract_features(probe, fc))
        tree, fc, _, _ = restore_policy(directory, trainer.policy,
                                        step=step, graphs=graphs or None)
        trainer.load_params(tree)
        trainer.feature_config = fc
        session.trainer = trainer
        session.platform = build_platform(spec)
        # head="device" policies decode against the platform's feature
        # table; rebind it so place()/evaluate() work straight after load
        # (a no-op for the dense head).
        trainer.bind_platform(session.platform)
        session.graphs = graphs
        return session
