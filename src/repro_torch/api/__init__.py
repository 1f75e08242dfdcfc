"""repro_torch.api — the v1 public API, PyTorch port.

One declarative document (:class:`PlacementSpec`) and one session object
(:class:`PlacementSession`) in front of the engine/workload/trainer
registries::

    from repro_torch.api import PlacementSpec, PlacementSession
    from repro_torch.core import HSDAGConfig

    spec = PlacementSpec(
        workload="benchmark;synthetic:family=mixed:count=9:size=30:seed=0",
        mode="corpus", config=HSDAGConfig(batch_chains=8))
    session = PlacementSession(spec)     # on the card; device="cpu" here
    session.fit()                        # dispatches to the right trainer
    session.save("ckpt/policy")          # params + features + spec + hash

The spec document and its hash are the reference's (``repro/api``), and
either package's session loads the other's checkpoints.  The warm service,
its server and the exported executables (``service.py``, ``server.py``,
``aot.py``) are not ported yet (ROADMAP.md 'Modules to port' item 8).
"""
from .session import PlacementSession
from .spec import (MODES, SPEC_VERSION, PlacementSpec, build_platform,
                   parse_platform_spec, platform_names, register_platform)

__all__ = [
    "PlacementSpec", "PlacementSession", "SPEC_VERSION", "MODES",
    "register_platform", "platform_names", "build_platform",
    "parse_platform_spec",
]
