"""The launch plan, the packed records and the one-time table checks of the
redesigned ``level_makespan`` kernel, on the CPU.

``level_launch_plan`` is the Python mirror of ``csrc/levelsim.cu``'s launch:
the route follows the shapes (``staged`` while the tables, finish vectors and
precomputed slot halves fit a block's shared memory, ``general`` after),
every (placement, real slot) is taken by exactly one active lane of the grid
(walked here as the kernel's index arithmetic walks it), and its constants
are the source's.  ``level_tensors`` repacks the tables once: real
predecessors first with data and pad predecessors folded into the sentinel,
and the kernel's records over the real slots; the plain version gives
bitwise the same output on the repacked tables as on the original ones."""
import dataclasses
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import PAPER_BENCHMARKS, paper_platform  # noqa: E402
from repro_torch.core import DeviceSpec, Platform  # noqa: E402
from repro_torch.core.costmodel import sim_arrays  # noqa: E402
from repro_torch.core.graph import CompGraph  # noqa: E402
from repro_torch.kernels import (build_chain_arrays,  # noqa: E402
                                 build_level_arrays, level_makespan,
                                 level_makespan_ref, level_tensors)
from repro_torch.kernels.levelsim import (  # noqa: E402
    MAX_WARPS, PARAMS, PRE, REG_QUEUES, ROUTES, SMEM_LIMIT, SMS,
    STATIC_WORDS, level_launch_plan, level_record_offsets, level_smem)

from test_torch_levelsim import _four_devices, _wide_dag  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _tables(name, devices=2):
    """(LevelArrays, LevelTensors, SimArrays) of a paper graph or the wide
    DAG on the paper platform or the four-device one."""
    g = (_wide_dag(CompGraph) if name == "wide"
         else PAPER_BENCHMARKS[name]())
    plat = (paper_platform() if devices == 2
            else _four_devices(DeviceSpec, Platform))
    sa = sim_arrays(g, plat, schedule="level")
    la = build_level_arrays(sa)
    return la, level_tensors(la, "cpu"), sa


def _plan_args(lt, B, Q):
    L, W, P, D = lt.shape
    return B, L, W, P, lt.num_nodes, D, Q, lt.slots


def _check_plan(lt, B, Q):
    """The plan's invariants, and every (placement, real slot) taken by one
    active lane of the grid, walked as the kernel's loops walk it."""
    L, W, P, D = lt.shape
    V, S = lt.num_nodes, lt.slots
    plan = level_launch_plan(*_plan_args(lt, B, Q))
    assert plan.route in ROUTES
    assert plan.group == min(32, 1 << (W - 1).bit_length())
    assert plan.group >= min(W, 32) and plan.per_warp * plan.group == 32
    assert plan.warps == MAX_WARPS
    assert 1 <= plan.per_block <= plan.per_warp * plan.warps
    assert plan.per_block <= max(1, -(-B // SMS))    # spread over the SMs
    assert plan.blocks == -(-B // plan.per_block)
    words = lt.offsets[-1]
    assert plan.smem == level_smem(plan.route, plan.per_block, V, D, Q, S,
                                   words) <= SMEM_LIMIT
    assert plan.queues == ("registers" if plan.route == "staged"
                           and D * Q <= REG_QUEUES else "shared")
    if plan.route == "general":     # staged did not fit even one placement
        assert level_smem("staged", 1, V, D, Q, S, words) > SMEM_LIMIT
    elif plan.per_block < min(-(-B // SMS), plan.per_warp * plan.warps):
        # fewer placements a block only where one more did not fit
        assert level_smem("staged", plan.per_block + 1, V, D, Q, S,
                          words) > SMEM_LIMIT

    first = lt.records[:L + 1].numpy().astype(np.int64)
    G = plan.group
    chunks = -(-W // G)
    cover = np.zeros((B, S), np.int64)
    leaders = np.zeros(B, np.int64)
    for blk in range(plan.blocks):
        b0 = blk * plan.per_block
        nb = min(plan.per_block, B - b0)
        for warp in range(plan.warps):
            lead = warp * plan.per_warp
            if lead >= nb:                   # a helper warp: no placements
                continue
            for lane in range(32):
                mine = lead + lane // G
                g = lane % G
                if mine >= nb:               # mirrors the block's last
                    continue
                leaders[b0 + mine] += g == 0
                for q in range(L * chunks):
                    lv, c = divmod(q, chunks)
                    base = first[lv] + c * G
                    n = max(0, min(first[lv + 1] - base, G))
                    if g < n:
                        cover[b0 + mine, base + g] += 1
    assert (leaders == 1).all()
    assert (cover == 1).all(), np.unique(cover)
    return plan


@pytest.mark.parametrize("name", ["inception_v3", "resnet50", "bert_base"])
@pytest.mark.parametrize("B", [1, 7, 320, 4096])
def test_level_plan_stages_the_paper_graphs(name, B):
    """The paper graphs take the staged route with queues in registers, G
    lanes a placement for their W, the batch spread over the SMs."""
    _, lt, sa = _tables(name)
    Q = sa.queue_init.shape[1]
    L, W, P, D = lt.shape
    plan = (_check_plan(lt, B, Q) if B <= 320
            else level_launch_plan(*_plan_args(lt, B, Q)))
    assert (plan.route, plan.queues) == ("staged", "registers")
    assert (plan.group, plan.per_warp) == {4: (4, 8), 2: (2, 16)}[W]
    assert plan.per_block == min(-(-B // SMS), {
        "inception_v3": 18, "resnet50": 32, "bert_base": 11}[name])
    assert plan.blocks * plan.per_block >= B
    assert plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("name", ["inception_v3", "resnet50", "bert_base"])
@pytest.mark.parametrize("B", [7, 320])
def test_level_plan_stages_the_chain_tables(name, B):
    """The scan backend's chain tables (one non-data node a row, in topo
    order): the staged route, one lane a placement, every (placement, row)
    taken once; the records hold one slot a row, in the topo order."""
    g = PAPER_BENCHMARKS[name]()
    sa = sim_arrays(g, paper_platform())
    lt = level_tensors(build_chain_arrays(sa), "cpu")
    L, W, P, D = lt.shape
    real = [int(v) for v in sa.order if not sa.is_data[v]]
    assert W == 1 and L == lt.slots == len(real) == {
        "inception_v3": 221, "resnet50": 124, "bert_base": 375}[name]
    rec = lt.records.numpy()
    off_nodes = lt.offsets[0]
    np.testing.assert_array_equal(rec[:L + 1], np.arange(L + 1))
    np.testing.assert_array_equal(rec[off_nodes:off_nodes + L], real)
    plan = _check_plan(lt, B, sa.queue_init.shape[1])
    assert (plan.route, plan.group, plan.per_warp, plan.queues) == (
        "staged", 1, 32, "registers")
    assert plan.per_block == -(-B // SMS)


@pytest.mark.parametrize("name,devices,B", [
    ("wide", 2, 7), ("wide", 4, 3), ("inception_v3", 4, 5), ("resnet50", 4, 9),
    ("bert_base", 2, 140)])
def test_level_plan_covers_every_placement_slot_once(name, devices, B):
    """Chunks of a level wider than a warp (W=40: two chunks of 32), queues
    in shared memory (D·Q = 12), a block of two placements (B=140)."""
    _, lt, sa = _tables(name, devices)
    plan = _check_plan(lt, B, sa.queue_init.shape[1])
    assert plan.route == "staged"
    assert plan.queues == ("shared" if devices == 4 else "registers")


@pytest.mark.parametrize("shape,route", [
    # the chip check's DAG: 60 levels of 64 slots of 8 preds
    ((7, 60, 64, 8, 3840, 2, 4, 3840), "general"),
    # finish vectors and device rows too large for one placement
    ((3, 10, 4, 2, 40000, 2, 4, 30), "general"),
    # just fits: one placement a block
    ((3, 10, 4, 2, 20000, 2, 4, 30), "staged"),
    # a long chain: 30,000 levels of one slot
    ((2, 30000, 1, 1, 30001, 2, 4, 30000), "general"),
])
def test_level_plan_takes_the_general_route_where_shared_memory_runs_out(
        shape, route):
    B, L, W, P, V, D, Q, S = shape
    plan = level_launch_plan(*shape)
    assert plan.route == route
    words = level_record_offsets(L, S, P, D)[-1]
    assert plan.smem == level_smem(route, plan.per_block, V, D, Q, S, words)
    assert plan.smem <= SMEM_LIMIT
    if route == "general":
        assert level_smem("staged", 1, V, D, Q, S, words) > SMEM_LIMIT
        assert plan.queues == "shared"


def test_level_plan_raises_where_not_even_the_queues_fit():
    with pytest.raises(ValueError, match="do not fit"):
        level_launch_plan(4, 3, 4, 2, 100, 64, 1024, 10)
    with pytest.raises(ValueError, match="positive"):
        level_launch_plan(0, 3, 4, 2, 100, 2, 4, 10)


def test_level_plan_constants_match_the_kernel_source():
    """The counts, routes, parameter order and register-queue shapes the
    plan assumes are the ones ``csrc/levelsim.cu`` uses."""
    src = (CSRC / "levelsim.cu").read_text()
    assert "constexpr int kWarp = 32;" in src
    assert f"constexpr int kMaxWarpsPerBlock = {MAX_WARPS};" in src
    assert f"constexpr int kRegQueueMax = {REG_QUEUES};" in src
    assert f"constexpr int kPre = {PRE};" in src
    assert "constexpr int kStatic = 4 + kPre;" in src
    assert STATIC_WORDS == 4 + PRE
    assert "enum Route { kStaged = 0, kGeneral = 1 };" in src
    assert ROUTES == ("staged", "general")
    enum = re.search(r"enum Param \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in enum.split(",")]
    assert names[-1] == "kParams"
    as_python = [re.sub(r"(?<!^)([A-Z])", r"_\1", n[1:]).lower()
                 for n in names[:-1]]
    assert as_python == [p.lower() for p in PARAMS]
    shapes = {(int(d), int(q))
              for d, q in re.findall(r"X\((\d+), (\d+)\)", src)}
    assert shapes == {(d, q) for d in range(1, REG_QUEUES + 1)
                      for q in range(1, REG_QUEUES + 1) if d * q <= REG_QUEUES}


@pytest.mark.parametrize("name,devices", [
    ("inception_v3", 2), ("resnet50", 2), ("bert_base", 2), ("wide", 2),
    ("wide", 4)])
def test_level_records_hold_the_compacted_tables(name, devices):
    """Decoded at ``level_record_offsets``, the kernel's records are the
    compacted tables over the real slots, level by level; every section
    starts on a 16-byte boundary."""
    la, lt, _ = _tables(name, devices)
    L, W, P, D = lt.shape
    V, S = lt.num_nodes, lt.slots
    off_nodes, off_upre, off_preds, off_dur, words = lt.offsets
    assert all(o % 4 == 0 for o in lt.offsets)
    rec = lt.records.numpy()
    assert rec.shape == (words,)
    real = la.nodes != V
    assert S == int(real.sum())
    first = rec[:L + 1]
    assert first[0] == 0 and first[-1] == S
    np.testing.assert_array_equal(np.diff(first), real.sum(axis=1))
    assert all(real[lv, :n].all() and not real[lv, n:].any()
               for lv, n in enumerate(np.diff(first)))   # pads trail
    np.testing.assert_array_equal(rec[off_nodes:off_nodes + S], la.nodes[real])
    preds = rec[off_preds:off_preds + 2 * S * P].reshape(S, P, 2)
    np.testing.assert_array_equal(preds[..., 0], lt.preds.numpy()[real])
    np.testing.assert_array_equal(preds[..., 1].view(np.float32),
                                  lt.pred_bytes.numpy()[real])
    upre = rec[off_upre:off_upre + S * PRE].reshape(S, PRE)
    np.testing.assert_array_equal(upre[:, :min(P, PRE)],
                                  lt.preds.numpy()[real][:, :PRE])
    assert (upre[:, min(P, PRE):] == V).all()
    np.testing.assert_array_equal(
        rec[off_dur:off_dur + S * D].view(np.float32).reshape(S, D),
        la.dur[real])
    # the compaction: real predecessors first in table order, the rest V
    data = lt.pred_data.numpy() > 0
    np.testing.assert_array_equal(data, lt.preds.numpy() == V)
    assert (lt.pred_bytes.numpy()[data] == 0).all()
    orig_real = la.pred_data == 0
    assert P == max(int(orig_real.sum(axis=2).max()), 1)
    for lv, w in zip(*np.nonzero(real)):
        want = la.preds[lv, w][orig_real[lv, w]]
        np.testing.assert_array_equal(lt.preds.numpy()[lv, w, :len(want)],
                                      want)


@pytest.mark.parametrize("name,devices", [
    ("inception_v3", 2), ("resnet50", 2), ("bert_base", 2), ("wide", 2),
    ("wide", 4), ("inception_v3", 4)])
def test_repacked_tables_give_bitwise_the_plain_versions_output(name,
                                                                devices):
    """``level_makespan_ref`` on the repacked tables and on the tables as
    ``build_level_arrays`` made them: bitwise equal finish and transfer."""
    la, lt, sa = _tables(name, devices)
    original = types.SimpleNamespace(
        nodes=torch.as_tensor(la.nodes), preds=torch.as_tensor(la.preds),
        dur=torch.as_tensor(la.dur),
        pred_bytes=torch.as_tensor(la.pred_bytes),
        pred_data=torch.as_tensor(la.pred_data), nodes_host=la.nodes)
    assert lt.preds.shape[2] <= la.preds.shape[2]
    rng = np.random.default_rng(7)
    placements = torch.as_tensor(rng.integers(
        0, devices, (6, lt.num_nodes)).astype(np.int32))
    platform = tuple(torch.as_tensor(np.ascontiguousarray(x))
                     for x in (sa.queue_init, sa.inv_bw, sa.lat))
    want_f, want_t = level_makespan_ref(original, placements, *platform)
    got_f, got_t = level_makespan_ref(lt, placements, *platform)
    assert torch.equal(got_f, want_f) and torch.equal(got_t, want_t)


def _lt():
    return _tables("resnet50")[1]


@pytest.mark.parametrize("field,bad", [
    ("nodes", lambda t: t.nodes.long()),                      # dtype
    ("dur", lambda t: t.dur.double()),
    ("preds", lambda t: t.preds[:-1]),                        # shape
    ("pred_data", lambda t: t.pred_data[:-1]),
    ("records", lambda t: t.records[:-4]),
    ("pred_bytes", lambda t: t.pred_bytes.transpose(0, 1).contiguous()
     .transpose(0, 1)),                                       # strided
    ("records", lambda t: torch.empty_like(t.records, device="meta")),
    ("records", lambda t: torch.cat([t.records, t.records[:4]])[1:-3]),
])
def test_level_tensors_reject_what_the_wrapper_checked_per_call(field, bad):
    lt = _lt()
    with pytest.raises(ValueError, match=f"LevelTensors: {field} must be"):
        dataclasses.replace(lt, **{field: bad(lt)})


def test_level_tensors_reject_counts_beyond_int32():
    lt = _lt()
    with pytest.raises(ValueError, match="int32"):
        dataclasses.replace(lt, num_nodes=2 ** 31)


def test_level_makespan_takes_only_cpu_or_cuda_tensors():
    """A CPU tensor runs the plain version and launches nothing; any other
    device but CUDA raises (a CUDA tensor launches the kernel or raises)."""
    _, lt, sa = _tables("resnet50")
    platform = tuple(torch.as_tensor(np.ascontiguousarray(x))
                     for x in (sa.queue_init, sa.inv_bw, sa.lat))
    place = torch.zeros(2, lt.num_nodes, dtype=torch.int32)
    launches = dict(level_makespan.route_launches)
    level_makespan(lt, place, *platform)
    assert level_makespan.route_launches == launches
    with pytest.raises(ValueError, match="CPU or CUDA"):
        level_makespan(lt, place.to("meta"), *platform)
