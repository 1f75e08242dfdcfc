"""HSDAG placement search through the PyTorch port's v1 API
(`repro_torch.api`), on the card unless ``--device cpu``.

The port's counterpart of ``examples/placement_search.py``: every run is one
:class:`repro_torch.api.PlacementSpec` — workload, platform, engine config,
training mode — driven by one :class:`repro_torch.api.PlacementSession`,
whose three modes map onto the three trainers::

    python examples/port_placement_search.py                  # BERT search
    python examples/port_placement_search.py --mode multi
    python examples/port_placement_search.py --mode corpus \\
        --workload "benchmark;synthetic:family=mixed:count=9:size=30:seed=0"
    python examples/port_placement_search.py --device cpu --episodes 2 \\
        --checkpoint /tmp/policy          # anywhere, with save/load
    python examples/port_placement_search.py --device cpu --episodes 2 \\
        --serve                           # then serve the graphs
    torchrun --nproc-per-node=4 examples/port_placement_search.py \\
        --mode corpus --mesh 2,2          # a 2x2 mesh: one rank a card

Each run prints its spec's hash, fits, evaluates every graph of the
workload with the greedy decode, and with ``--checkpoint`` saves the session
(the reference's checkpoint format: either package loads it) and loads it
back, checking that the loaded policy decodes the same placements.  Search
mode then runs the paper's technique in its production slot:
``plan_stages`` splits phi3-mini-3.8b's layer graph over two pipeline
stages (``tpu_stage_platform``) beside the even split.  With ``--serve``
the fitted session's graphs are then served twice (cold, then warm) through
a :class:`repro_torch.api.PlacementService` and once through an
:class:`repro_torch.api.AsyncPlacementServer`, each checked against the
session's own placements, and both ``stats()`` are printed.

``--mesh G,B`` (corpus mode) tiles each episode's chain grid over a
("graphs", "chains") mesh of G·B ranks: launch it with ``torchrun
--nproc-per-node=G*B`` (NCCL, one card a rank; ``--device cpu``: gloo),
which the script joins before fitting; only rank 0 prints and writes.
``--mesh 1,1`` runs without torchrun, bit for bit the unsharded run.
"""
import argparse
import os
import sys

import numpy as np
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.api import (AsyncPlacementServer,  # noqa: E402
                             PlacementService, PlacementSession,
                             PlacementSpec, build_platform,
                             parse_platform_spec)
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import HSDAGConfig, simulate  # noqa: E402
from repro_torch.core.baselines import cpu_only  # noqa: E402
from repro_torch.core.planner import plan_stages  # noqa: E402

DEFAULT_WORKLOADS = {
    "search": "benchmark:names=bert_base",
    "multi": "benchmark:names=inception_v3+resnet50",
    "corpus": "benchmark;synthetic:family=mixed:count=9:size=30:seed=0",
}


def build_spec(args) -> PlacementSpec:
    """One declarative document from the command line."""
    name, pargs = parse_platform_spec(args.platform)
    num_devices = build_platform(PlacementSpec(
        workload="", platform=name, platform_args=pargs)).num_devices
    # search/multi keep the paper driver's variance-reduction knobs; the
    # corpus trainer's per-graph standardization subsumes them
    extras = ({} if args.mode == "corpus"
              else dict(use_baseline=True, normalize_weights=True))
    return PlacementSpec(
        workload=args.workload or DEFAULT_WORKLOADS[args.mode],
        mode=args.mode, platform=name, platform_args=pargs,
        head=args.head or None,
        mesh=[int(x) for x in args.mesh.split(",")] if args.mesh else None,
        config=HSDAGConfig(num_devices=num_devices,
                           max_episodes=args.episodes, update_timestep=10,
                           batch_chains=args.chains, engine=args.engine,
                           seed=args.seed, **extras))


def serve(session: PlacementSession, placements) -> bool:
    """Serve the session's graphs through the warm service (twice: cold,
    then warm) and the async server; → every placement the session's."""
    graphs = list(session.graphs)
    service = PlacementService(session)
    served = service.place_many(graphs) + service.place_many(graphs)
    with AsyncPlacementServer(batch_slots=4, max_delay_ms=5.0) as server:
        server.register(session)
        served += server.place_many(graphs, timeout=600)
        stats = server.stats()
    print(f"\nservice stats: {service.stats()}")
    print(f"server stats:  {stats}")
    same = all(np.array_equal(p, want)
               for p, want in zip(served, placements * 3))
    print(f"served placements equal the session's: {same}")
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="search",
                    choices=("search", "multi", "corpus"))
    ap.add_argument("--workload", default="",
                    help="corpus spec string; the default depends on --mode")
    ap.add_argument("--platform", default="paper",
                    help="'name[:key=value:...]': paper, tpu_stage, "
                         "nvlink_island, multi_host, torus, ring")
    ap.add_argument("--head", default="", choices=("", "dense", "device"))
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="",
                    help="save the session here and load it back")
    ap.add_argument("--serve", action="store_true",
                    help="after fit, serve the graphs through the service "
                         "and the async server")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mesh", default="",
                    help="corpus mode: G,B, the ('graphs', 'chains') mesh "
                         "(run under torchrun --nproc-per-node=G*B)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.mesh and args.mode != "corpus":
        ap.error("--mesh tiles the corpus trainer: pass --mode corpus")
    if "WORLD_SIZE" in os.environ:       # launched by torchrun
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
        if dist.get_rank():
            sys.stdout = open(os.devnull, "w")
    try:
        return run(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(args) -> int:

    spec = build_spec(args)
    print(f"spec_hash {spec.spec_hash()} mode={spec.mode} "
          f"workload={spec.workload!r} device={args.device}")
    session = PlacementSession(spec, device=args.device)
    res = session.fit(rng=args.seed, verbose=args.verbose)
    print(f"fit: {res.num_evaluations} placements at "
          f"{res.evals_per_sec:.1f}/s in {res.wall_time_s:.2f} s")
    placements = []
    for g in session.graphs:
        p, lat = session.evaluate(g)
        placements.append(p)
        cpu = simulate(g, cpu_only(g), session.platform).latency
        print(f"  {g.name[:32]:32s} CPU-only {cpu * 1e3:9.3f} ms → greedy "
              f"{lat * 1e3:9.3f} ms ({100 * (cpu - lat) / cpu:5.1f}%)")
    if args.checkpoint:
        session.save(args.checkpoint)
        loaded = PlacementSession.load(args.checkpoint, device=args.device)
        same = all(np.array_equal(loaded.place(g), p)
                   for g, p in zip(session.graphs, placements))
        print(f"saved to {args.checkpoint}; loaded spec_hash "
              f"{loaded.spec.spec_hash()[:16]}, same greedy placements: "
              f"{same}")
        if not same:
            return 1
    if args.serve and not serve(session, placements):
        return 1
    if spec.mode == "search":
        cfg = get("phi3-mini-3.8b").config
        plan = plan_stages(cfg, seq_len=4096, batch=256, num_stages=2,
                           device=args.device)
        print(f"\nphi3-mini-3.8b x train_4k across 2 pipeline stages:")
        print(f"  even-split makespan : {plan.baseline_latency * 1e3:.2f} ms")
        print(f"  HSDAG-planned       : {plan.latency * 1e3:.2f} ms")
        print(f"  stage boundaries at layer-graph nodes {plan.boundaries}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
