"""PlacementSpec — one declarative, JSON-round-trippable document per run.

Port of ``repro/api/spec.py``: the same fields, defaults, validations and
error messages, so a document (and its :meth:`PlacementSpec.spec_hash`) is
the same in both packages and a checkpoint of either names its run for the
other.  The torch device is not a spec field: it is an argument of
:class:`~repro_torch.api.PlacementSession`.

Three parallel training entry points (``HSDAG.search``,
``MultiGraphTrainer.train``, ``CurriculumTrainer.train_corpus``), each with
its own argparse glue.  A :class:`PlacementSpec` subsumes all of it: the
workload (a corpus spec string the workload registry materializes), the
named platform, the engine/config (:class:`~repro_torch.core.HSDAGConfig`), the
training ``mode`` and the mode's sampler/bucket/checkpoint knobs — one
document fully names a run.

The document is versioned and canonical: :meth:`PlacementSpec.to_json`
emits sorted-key JSON, :meth:`PlacementSpec.from_json` rejects unknown
fields by name, and :meth:`PlacementSpec.spec_hash` content-hashes the
canonical form.  Checkpoint manifests written by
:meth:`repro_torch.api.PlacementSession.save` record the hash alongside the
corpus fingerprint, so a restored policy knows exactly which run produced
it.

Platforms are named through a small registry (mirroring the simulator
backend and workload registries).  Besides the paper's 2-device
``"paper"`` fleet and the ``"tpu_stage"`` pipeline stage, the registry
ships the topology-aware builders from :mod:`repro_torch.platforms` —
``"nvlink_island"``, ``"multi_host"``, ``"torus"`` and ``"ring"`` — whose
non-uniform link matrices and device coordinates drive the
``head="device"`` policy.
Builder keyword arguments ride in ``platform_args`` (or a colon-separated
``parse_platform_spec`` string, the CLI form)::

    register_platform("my_cluster", build_my_cluster)
    PlacementSpec(workload="benchmark", platform="my_cluster")
    PlacementSpec(workload="benchmark", platform="nvlink_island",
                  platform_args={"islands": 2, "gpus_per_island": 4})
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Dict, List, Mapping, Optional, Union

from ..core.costmodel import Platform, paper_platform, tpu_stage_platform
from ..core.features import FeatureConfig
from ..core.hsdag import HSDAGConfig
from ..core.train.population import PopulationConfig
from ..graphs.workloads import parse_corpus_spec

__all__ = ["PlacementSpec", "SPEC_VERSION", "MODES",
           "register_platform", "platform_names", "build_platform",
           "parse_platform_spec"]

SPEC_VERSION = 1

#: fit dispatch targets: single-graph search, padded multi-graph joint
#: training, bucketed corpus curriculum.
MODES = ("search", "multi", "corpus")

_SAMPLERS = ("uniform", "stratified", "plateau")
_REWARD_NORMS = ("none", "pergraph")

# ------------------------------------------------------------------ platforms
_PLATFORMS: Dict[str, Callable[..., Platform]] = {}


def register_platform(name: str,
                      builder: Callable[..., Platform]) -> None:
    """Register ``builder`` under ``name`` (latest wins) — the name becomes
    a valid ``PlacementSpec.platform`` value."""
    _PLATFORMS[name] = builder


def platform_names() -> List[str]:
    return sorted(_PLATFORMS)


def _register_topologies() -> None:
    from ..platforms import multi_host, nvlink_island, ring, torus
    register_platform("nvlink_island", nvlink_island)
    register_platform("multi_host", multi_host)
    register_platform("torus", torus)
    register_platform("ring", ring)


register_platform("paper", paper_platform)
register_platform("tpu_stage", tpu_stage_platform)
_register_topologies()


def build_platform(spec: "PlacementSpec") -> Platform:
    """Materialize ``spec.platform`` (+ ``platform_args``) into a Platform."""
    builder = _PLATFORMS[spec.platform]
    try:
        return builder(**dict(spec.platform_args))
    except TypeError as e:
        raise ValueError(
            f"platform {spec.platform!r} rejected platform_args "
            f"{dict(spec.platform_args)}: {e}") from None


def parse_platform_spec(spec: str):
    """``"name:key=value:..."`` → ``(name, args)`` — the CLI platform form.

    Mirrors :func:`~repro_torch.graphs.workloads.parse_corpus_spec`'s error
    contract: every rejection is a ``ValueError`` naming the offending
    colon-separated segment by position and text.  Values parse as int,
    then float, else stay strings (builders validate semantics).

        >>> parse_platform_spec("nvlink_island:islands=2:gpus_per_island=4")
        ('nvlink_island', {'islands': 2, 'gpus_per_island': 4})
    """
    parts = [p.strip() for p in str(spec).split(":")]
    name = parts[0]
    if not name:
        raise ValueError(
            f"platform spec segment 0 ({parts[0]!r}): empty platform name; "
            f"registered platforms: {platform_names()}")
    if name not in _PLATFORMS:
        raise ValueError(
            f"platform spec segment 0 ({name!r}): unknown platform; "
            f"registered platforms: {platform_names()}")
    args: Dict[str, object] = {}
    for pos, part in enumerate(parts[1:], start=1):
        if not part:
            raise ValueError(
                f"platform spec segment {pos} ({part!r}): empty segment — "
                f"expected key=value")
        if "=" not in part:
            raise ValueError(
                f"platform spec segment {pos} ({part!r}): expected "
                f"key=value")
        key, _, raw = part.partition("=")
        key, raw = key.strip(), raw.strip()
        if not key or not raw:
            raise ValueError(
                f"platform spec segment {pos} ({part!r}): empty "
                f"{'key' if not key else 'value'} in key=value")
        if key in args:
            raise ValueError(
                f"platform spec segment {pos} ({part!r}): duplicate key "
                f"{key!r}")
        try:
            val: object = int(raw)
        except ValueError:
            try:
                val = float(raw)
            except ValueError:
                val = raw
        args[key] = val
    return name, args


# ----------------------------------------------------------------- the spec
# FeatureConfig knobs a spec may set.  The vocabulary fields are derived
# from the workload at fit time (shared_feature_config) — a spec carrying
# them would desynchronize from its own corpus, so they are rejected.
_FEATURE_FIELDS = tuple(sorted(
    f.name for f in dataclasses.fields(FeatureConfig)
    if not f.name.endswith("_vocab")))


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """See module docstring.  Example::

        spec = PlacementSpec(
            workload="benchmark;synthetic:family=mixed:count=9:size=30",
            mode="corpus",
            config=HSDAGConfig(batch_chains=8, max_episodes=40),
            max_buckets=3, graphs_per_episode=4)
        session = PlacementSession(spec)
        session.fit()
    """

    #: corpus spec string the workload registry materializes (may be empty
    #: only when ``fit(graphs=...)`` supplies the graphs explicitly).
    workload: str
    mode: str = "search"
    platform: str = "paper"
    platform_args: Mapping = dataclasses.field(default_factory=dict)
    config: HSDAGConfig = dataclasses.field(default_factory=HSDAGConfig)
    #: FeatureConfig knobs (``d_pos``, ``use_structural``, ...); the
    #: vocabularies are always derived from the workload, never specified.
    feature: Mapping = dataclasses.field(default_factory=dict)
    #: overrides ``config.max_episodes`` when set (the episode budget knob
    #: CLIs expose without re-serializing the whole config).
    episodes: Optional[int] = None
    #: overrides ``config.head`` when set — ``"dense"`` (the paper's fixed
    #: output layer) or ``"device"`` (platform-conditioned compatibility
    #: head); the CLI knob that pairs with ``--platform``.
    head: Optional[str] = None
    # --- multi/corpus knobs ---
    reward_norm: str = "pergraph"
    # --- corpus knobs (CurriculumTrainer) ---
    max_buckets: int = 4
    graphs_per_episode: int = 4
    sampler: str = "stratified"
    plateau_patience: int = 5
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    #: path of a ``save_policy`` checkpoint to fine-tune from (corpus mode).
    warm_start: Optional[str] = None
    #: ``[graphs, chains]`` device-mesh factorization for the sharded
    #: rollout engine (corpus mode); ``None`` = unsharded.  ``[1, 1]``
    #: trains bit-for-bit identically to ``None``.
    mesh: Optional[List[int]] = None
    #: build the workload as a :class:`~repro_torch.graphs.StreamingCorpus`
    #: (corpus mode) — graphs materialize lazily behind an LRU instead of
    #: as one dense list.  A ``stream:``/``eager:`` marker inside
    #: ``workload`` must agree with this flag.
    stream: bool = False
    #: PBT-style chain-population search over the B chains (culling, elite
    #: exchange, greedy restarts — :class:`~repro_torch.core.train.
    #: PopulationConfig` or its dict form).  ``None`` keeps every engine
    #: bit-for-bit identical to the plain run.  Valid in all three modes.
    population: Optional[PopulationConfig] = None
    #: host/device overlap for corpus mode: prefetch episode t+1's batch
    #: arrays on a background thread while episode t runs on device.
    #: ``"auto"`` enables it for multi-episode runs; ``"on"``/``"off"``
    #: force.  Bit-for-bit neutral — only wall-clock changes.
    prefetch: str = "auto"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; expected one "
                             f"of {MODES}")
        if self.platform not in _PLATFORMS:
            raise ValueError(
                f"unknown platform {self.platform!r}; registered "
                f"platforms: {platform_names()}")
        if isinstance(self.config, (dict, str)):
            object.__setattr__(self, "config",
                               HSDAGConfig.from_json(self.config))
        elif not isinstance(self.config, HSDAGConfig):
            raise ValueError(
                f"config must be an HSDAGConfig (or its JSON/dict form), "
                f"got {type(self.config).__name__}")
        if self.workload:
            cspec = parse_corpus_spec(self.workload)  # segment validation
            if self.stream and cspec.mode == "eager":
                raise ValueError(
                    f"stream=True contradicts the workload's 'eager' "
                    f"marker ({self.workload!r}) — drop one of them")
        unknown = sorted(set(self.feature) - set(_FEATURE_FIELDS))
        if unknown:
            raise ValueError(
                f"unknown feature fields {unknown}; settable fields: "
                f"{list(_FEATURE_FIELDS)} (vocabularies are derived from "
                f"the workload at fit time)")
        if self.reward_norm not in _REWARD_NORMS:
            raise ValueError(f"unknown reward_norm {self.reward_norm!r}; "
                             f"expected one of {_REWARD_NORMS}")
        if isinstance(self.population, (dict, str)):
            object.__setattr__(self, "population",
                               PopulationConfig.from_json(self.population))
        elif not (self.population is None
                  or isinstance(self.population, PopulationConfig)):
            raise ValueError(
                f"population must be a PopulationConfig (or its JSON/dict "
                f"form) or None, got {type(self.population).__name__}")
        if self.prefetch not in ("auto", "on", "off"):
            raise ValueError(f"unknown prefetch {self.prefetch!r}; expected "
                             f"'auto', 'on' or 'off'")
        if self.sampler not in _SAMPLERS:
            raise ValueError(f"unknown sampler {self.sampler!r}; expected "
                             f"one of {_SAMPLERS}")
        if self.episodes is not None and self.episodes < 1:
            raise ValueError("episodes must be >= 1 when set")
        if self.head is not None and self.head not in ("dense", "device"):
            raise ValueError(f"unknown head {self.head!r}; expected "
                             f"'dense' or 'device'")
        if self.mesh is not None:
            m = list(self.mesh)
            if len(m) != 2 or not all(
                    isinstance(v, int) and not isinstance(v, bool) and v >= 1
                    for v in m):
                raise ValueError(
                    f"mesh must be two positive ints [graphs, chains], "
                    f"got {self.mesh!r}")
            object.__setattr__(self, "mesh", m)
        if self.mode != "corpus":
            bad = [k for k, v in (("warm_start", self.warm_start),
                                  ("checkpoint_dir", self.checkpoint_dir),
                                  ("checkpoint_every",
                                   self.checkpoint_every or None),
                                  ("mesh", self.mesh),
                                  ("stream", self.stream or None)) if v]
            if bad:
                raise ValueError(
                    f"{bad} only apply to mode='corpus' (got "
                    f"mode={self.mode!r})")
        # normalize mappings to plain sorted dicts so equality and the
        # canonical JSON form are independent of insertion order
        object.__setattr__(self, "platform_args",
                           {k: self.platform_args[k]
                            for k in sorted(self.platform_args)})
        object.__setattr__(self, "feature",
                           {k: self.feature[k] for k in sorted(self.feature)})

    # ------------------------------------------------------------- transport
    def to_json(self) -> str:
        """Canonical (sorted-key) JSON document, ``version``-stamped."""
        doc = dataclasses.asdict(self)
        doc["config"] = dataclasses.asdict(self.config)
        if self.population is not None:
            doc["population"] = dataclasses.asdict(self.population)
        doc["version"] = SPEC_VERSION
        return json.dumps(doc, sort_keys=True)

    @classmethod
    def from_json(cls, doc: Union[str, Mapping]) -> "PlacementSpec":
        """Inverse of :meth:`to_json`; unknown fields are rejected by name."""
        data = json.loads(doc) if isinstance(doc, str) else dict(doc)
        if not isinstance(data, dict):
            raise ValueError(
                f"PlacementSpec JSON must be an object, got "
                f"{type(data).__name__}")
        version = data.pop("version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise ValueError(f"unsupported PlacementSpec version {version!r}"
                             f" (this build reads version {SPEC_VERSION})")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(f"unknown PlacementSpec fields {unknown}; "
                             f"known fields: {sorted(known)}")
        return cls(**data)

    def spec_hash(self) -> str:
        """Content hash of the canonical JSON form — two specs hash equal
        iff they name the same run.  Recorded in checkpoint manifests
        alongside the corpus fingerprint."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()

    # -------------------------------------------------------------- derived
    def resolved_config(self) -> HSDAGConfig:
        """``config`` with the ``episodes`` / ``head`` overrides applied."""
        overrides = {}
        if self.episodes is not None:
            overrides["max_episodes"] = self.episodes
        if self.head is not None:
            overrides["head"] = self.head
        if not overrides:
            return self.config
        return dataclasses.replace(self.config, **overrides)

    def feature_base(self) -> FeatureConfig:
        """The FeatureConfig base the shared vocabularies are grafted on."""
        return FeatureConfig(**dict(self.feature))
