"""repro_torch.api — the v1 public API, PyTorch port.

One declarative document (:class:`PlacementSpec`), one session object
(:class:`PlacementSession`) and one warm server (:class:`PlacementService`,
with :class:`AsyncPlacementServer` batching requests that arrive one at a
time) in front of the engine/workload/trainer registries::

    from repro_torch.api import (PlacementService, PlacementSession,
                                 PlacementSpec)
    from repro_torch.core import HSDAGConfig

    spec = PlacementSpec(
        workload="benchmark;synthetic:family=mixed:count=9:size=30:seed=0",
        mode="corpus", config=HSDAGConfig(batch_chains=8))
    session = PlacementSession(spec)     # on the card; device="cpu" here
    session.fit()                        # dispatches to the right trainer
    session.save("ckpt/policy")          # params + features + spec + hash

    service = PlacementService("ckpt/policy")   # device="cpu" here
    placement = service.place(new_graph)  # warm: cached device inputs

The spec document and its hash are the reference's (``repro/api``), and
either package's session loads the other's checkpoints.  The service's
persistent AOT cache stores what a fresh process checks and loads before
a bucket's decode, not a compiled executable (``aot.py``).
"""
from .aot import AotExecutableCache
from .server import AsyncPlacementServer
from .service import PlacementRequestError, PlacementService
from .session import PlacementSession
from .spec import (MODES, SPEC_VERSION, PlacementSpec, build_platform,
                   parse_platform_spec, platform_names, register_platform)

__all__ = [
    "PlacementSpec", "PlacementSession", "PlacementService",
    "AsyncPlacementServer", "AotExecutableCache", "PlacementRequestError",
    "SPEC_VERSION", "MODES",
    "register_platform", "platform_names", "build_platform",
    "parse_platform_spec",
]
