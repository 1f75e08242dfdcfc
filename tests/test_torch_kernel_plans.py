"""The launch plans and graph checks of the redesigned ``rmsnorm`` and
``gcn_aggregate`` kernels, on the CPU.

``rmsnorm_launch_plan`` is the Python mirror of ``csrc/rmsnorm.cu``'s
launch: every element of every row is covered exactly once by the plan's
grid, block and per-thread vectors (walked here as the kernel's index
arithmetic walks them), the route follows the rows, and a vector route is
taken only where ``d`` and the pointers allow 16-byte loads.  ``GCNGraph``
now checks its tensors once, where it is built, in place of the per-call
checks the wrapper made.  The CPU path of both wrappers is held against the
Pallas kernels in interpret mode at the widths the new routes split on."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.gcn_spmm import gcn_aggregate as ref_gcn  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as ref_rmsnorm  # noqa: E402

from repro_torch.kernels import (gcn_aggregate, gcn_graph,  # noqa: E402
                                 rmsnorm)
from repro_torch.kernels.gcn_spmm import GCNGraph  # noqa: E402
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    BLOCK_COUNTS, FEW_ROWS, GENERAL_THREADS, MAX_BLOCK_THREADS, ROUTES,
    WARP_COUNTS, WARP_ROWS, rmsnorm_launch_plan)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - hypothesis is a test extra
    given = None

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ------------------------------------------------------- rmsnorm's plan
def _row_cover(plan, d):
    """How often each element of one row is touched by the row's threads,
    walked as the kernel's loops walk it."""
    cover = np.zeros(d, np.int64)
    nvec = d // plan.vec
    if plan.route == "general":
        for t in range(plan.threads):
            cover[t::plan.threads] += 1
        return cover
    # warp_vec: a row's 32 lanes; block_vec: the block's threads
    width = 32 if plan.route == "warp_vec" else plan.threads
    for k in range(plan.per_thread):
        for t in range(width):
            idx = k * width + t
            if idx < nvec:
                cover[idx * plan.vec:(idx + 1) * plan.vec] += 1
    return cover


def _check_plan(rows, d, dtype, aligned):
    plan = rmsnorm_launch_plan(rows, d, dtype, aligned)
    itemsize = dtype.itemsize
    assert plan.route in ROUTES
    assert plan.threads % 32 == 0 and 0 < plan.threads
    # rows: block b takes rows b·rows_per_block ...; every row once
    assert plan.blocks == -(-rows // plan.rows_per_block)
    assert plan.blocks < 2 ** 31
    if plan.route == "warp_vec":
        assert plan.threads == 32 * WARP_ROWS == 32 * plan.rows_per_block
        assert plan.per_thread in WARP_COUNTS
        assert d * 4 <= 48 * 1024           # scale in static-size smem
    else:
        assert plan.rows_per_block == 1
        assert plan.threads <= MAX_BLOCK_THREADS
    if plan.route == "block_vec":
        assert plan.per_thread in BLOCK_COUNTS
    if plan.route == "general":
        assert plan.vec == 1 and plan.threads <= GENERAL_THREADS
        assert plan.per_thread == -(-d // plan.threads)
    else:
        # a vector route: whole 16-byte vectors from aligned row starts
        assert aligned and plan.vec * itemsize == 16 and d % plan.vec == 0
    # the route follows the rows
    if plan.route == "warp_vec":
        assert rows > FEW_ROWS
    if rows <= FEW_ROWS:
        assert plan.route != "warp_vec"
    # every element of a row exactly once
    cover = _row_cover(plan, d)
    assert (cover == 1).all(), (plan, np.unique(cover))
    return plan


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 4, 5, 1024, 1025, 16384, 18432])
@pytest.mark.parametrize("d", [1, 37, 200, 768, 1536, 2560, 5120, 8192,
                               40000])
def test_rmsnorm_plan_covers_every_element_once(rows, d, dtype):
    _check_plan(rows, d, DTYPES[dtype], True)
    _check_plan(rows, d, DTYPES[dtype], False)


@pytest.mark.parametrize("rows,d,dtype,aligned,want", [
    # the serves' shapes: prefill on the warp route, decode's 4 rows a
    # block each (one 16-byte vector a thread)
    (18432, 2560, "bfloat16", True, ("warp_vec", 10, 256, 2304)),
    (16384, 768, "bfloat16", True, ("warp_vec", 3, 256, 2048)),
    (16384, 1536, "float32", True, ("warp_vec", 12, 256, 2048)),
    (4, 2560, "bfloat16", True, ("block_vec", 1, 320, 4)),
    (4, 768, "bfloat16", True, ("block_vec", 1, 96, 4)),
    (4, 1536, "float32", True, ("block_vec", 1, 384, 4)),
    # the f32 consistency checks at danube's width
    (400, 2560, "float32", True, ("block_vec", 2, 320, 400)),
    (1025, 2560, "float32", True, ("warp_vec", 20, 256, 129)),
    # the boundary between the two vector routes
    (1024, 768, "bfloat16", True, ("block_vec", 1, 96, 1024)),
    (1025, 768, "bfloat16", True, ("warp_vec", 3, 256, 129)),
    # a row too wide for a warp's registers: a block a row
    (18432, 8192, "bfloat16", True, ("block_vec", 2, 512, 18432)),
    (18432, 8192, "float32", True, ("block_vec", 4, 512, 18432)),
    # what no vector route takes: ragged d, unaligned pointers, huge rows
    (18432, 37, "float32", True, ("general", 1, 64, 18432)),
    (4, 2560, "bfloat16", False, ("general", 10, 256, 4)),
    (18432, 2560, "float32", False, ("general", 10, 256, 18432)),
    (2, 36, "bfloat16", True, ("general", 1, 64, 2)),
    (3, 40000, "float32", True, ("general", 157, 256, 3)),
])
def test_rmsnorm_route_follows_rows_and_alignment(rows, d, dtype, aligned,
                                                  want):
    plan = _check_plan(rows, d, DTYPES[dtype], aligned)
    assert (plan.route, plan.per_thread, plan.threads, plan.blocks) == want


def test_rmsnorm_plan_constants_match_the_kernel_source():
    """The counts, block sizes and route order the plan assumes are the
    ones ``csrc/rmsnorm.cu`` instantiates and launches."""
    src = (CSRC / "rmsnorm.cu").read_text()
    warp = tuple(int(n) for n in re.findall(r"RMS_WARP\((\d+)\)", src))
    block = tuple(int(n) for n in re.findall(r"RMS_BLOCK\((\d+)\)", src))
    assert warp == WARP_COUNTS and block == BLOCK_COUNTS
    assert f"kRowsPerWarpBlock = {WARP_ROWS};" in src
    assert f"kMaxBlockThreads = {MAX_BLOCK_THREADS};" in src
    assert "enum Route { kWarpVec = 0, kBlockVec = 1, kGeneral = 2 };" in src
    assert ROUTES == ("warp_vec", "block_vec", "general")


if given is not None:
    @settings(max_examples=80, deadline=None)
    @given(rows=st.integers(1, 3000), d=st.integers(1, 12000),
           dtype=st.sampled_from(["float32", "bfloat16"]),
           aligned=st.booleans())
    def test_rmsnorm_plan_property(rows, d, dtype, aligned):
        """Any (rows, d, dtype, alignment): every element once, the vector
        routes only on aligned rows of whole vectors, the route by rows."""
        _check_plan(rows, d, DTYPES[dtype], aligned)


# ------------------------------------------------ the CPU path vs Pallas
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(1, 37), (5, 200), (4, 2560),
                                    (9, 1536), (3, 8192)])
def test_rmsnorm_cpu_path_matches_pallas_at_route_widths(rows, d, dtype):
    rng = np.random.default_rng(rows * 10007 + d)
    x_np = rng.standard_normal((rows, d)).astype(np.float32)
    s_np = (rng.standard_normal(d) + 1.0).astype(np.float32)
    want = ref_rmsnorm(jnp.asarray(x_np, getattr(jnp, dtype)),
                       jnp.asarray(s_np), interpret=True)
    launches = dict(rmsnorm.route_launches)
    got = rmsnorm(torch.from_numpy(x_np).to(DTYPES[dtype]),
                  torch.from_numpy(s_np))
    assert rmsnorm.route_launches == launches   # CPU: the plain version
    assert got.dtype == DTYPES[dtype]
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _problem(v, f, chains, seed):
    rng = np.random.default_rng(seed)
    edges = np.argwhere(np.triu(rng.random((v, v)) < 3.0 / v, k=1))
    keep = (rng.random((chains, len(edges))) < 0.8).astype(np.float32)
    h = rng.standard_normal((chains, v, f)).astype(np.float32)
    return edges.astype(np.int32), keep, h


@pytest.mark.parametrize("f", [37, 128, 200])
def test_gcn_cpu_path_matches_pallas_at_route_widths(f):
    """F = 37 (the kernel's scalar route), 128 and 200 (its float4 route,
    200 with a ragged second pass of 128 features)."""
    v = 53
    edges, keep, h = _problem(v, f, chains=2, seed=f)
    graph = gcn_graph(edges, v, "cpu")
    launches = dict(gcn_aggregate.route_launches)
    got = gcn_aggregate(graph, torch.from_numpy(keep), torch.from_numpy(h))
    assert gcn_aggregate.route_launches == launches
    for b in range(keep.shape[0]):
        adj = np.zeros((v, v), np.float32)
        adj[edges[:, 0], edges[:, 1]] = keep[b]
        want = ref_gcn(jnp.asarray(adj), jnp.asarray(h[b]), interpret=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# -------------------------------------------- the graph's one-time checks
def _graph():
    edges, _, _ = _problem(20, 4, chains=1, seed=3)
    return gcn_graph(edges, 20, "cpu")


@pytest.mark.parametrize("field,bad", [
    ("csr", lambda g: g.csr.long()),                       # dtype
    ("eid", lambda g: g.eid.float()),
    ("rowptr", lambda g: g.rowptr.long()),
    ("src", lambda g: g.src.int()),
    ("rowptr", lambda g: g.rowptr[:-1]),                   # shape
    ("csr", lambda g: g.csr[:, :3]),
    ("dst", lambda g: g.dst[:-1]),
    ("eid", lambda g: torch.stack([g.eid, g.eid], 1)[:, 0]),   # strided
    ("csr", lambda g: torch.empty_like(g.csr, device="meta")),  # device
    ("csr", lambda g: torch.cat([g.csr.flatten(), g.csr.flatten()[:4]])
     [1:-3].view(-1, 4)),                                  # 16-byte boundary
])
def test_gcn_graph_rejects_what_the_wrapper_checked_per_call(field, bad):
    g = _graph()
    with pytest.raises(ValueError, match=f"GCNGraph: {field} must be"):
        dataclasses.replace(g, **{field: bad(g)})


def test_gcn_graph_rejects_counts_beyond_int32_and_keeps_its_device():
    g = _graph()
    assert g.device == torch.device("cpu")
    with pytest.raises(ValueError, match="int32 CSR"):
        dataclasses.replace(g, num_nodes=2 ** 31)
    with pytest.raises(ValueError, match="int32 CSR"):
        GCNGraph(*(torch.empty(0, dtype=t.dtype)
                   for t in (g.src, g.dst, g.rowptr, g.csr, g.eid)), -1)


def test_wrappers_raise_on_a_device_that_is_neither_cpu_nor_cuda():
    """Only a CPU tensor takes the plain version: on any other device the
    wrappers raise (here meta tensors; a CUDA tensor launches the kernel
    or raises)."""
    g = _graph()
    meta = dataclasses.replace(g, **{n: getattr(g, n).to("meta")
                                     for n in ("src", "dst", "rowptr", "csr",
                                               "eid")})
    h = torch.empty(2, 20, 8, device="meta")
    keep = torch.empty(2, g.num_edges, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gcn_aggregate(meta, keep, h)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rmsnorm(torch.empty(4, 8, device="meta"),
                torch.empty(8, device="meta"))
