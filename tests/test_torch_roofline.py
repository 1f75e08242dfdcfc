"""Port parity, the roofline and its report (``repro_torch/launch/roofline.py``
and ``launch/report.py`` against ``repro/launch/{roofline,report}.py``), and
the LM kernels' work counts (``kernels/*.py`` ``*_work``, which
``chip_smoke.py``'s bound column and the dry run both read) with their
shape-only and counted routes.

The port keeps the reference's keys and arithmetic and changes only the
constants (H100 SXM for TPU v5e) and the collective term, which sums each
mesh axis's bytes at its own link's rate.  So on one cell: the useful ratio
and 6·N·D are equal, and each term times its rate (FLOPs, bytes, wire
bytes) agrees to 1e-15 (a division and a product apart).  The work counts
are pinned, exactly, to the numbers PERF.md §6 prints for each kernel's
timed shape.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import report as ref_report  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402

from repro_torch.kernels import (flash_attention, flash_attention_ref,  # noqa: E402
                                 flash_attention_work, flash_pairs, rmsnorm,
                                 rmsnorm_ref, rmsnorm_work, ssd_scan,
                                 ssd_scan_ref, ssd_scan_work)
from repro_torch.kernels._work import COUNTER, causal_pairs  # noqa: E402
from repro_torch.launch import report, roofline  # noqa: E402
from repro_torch.launch.roofline import HW  # noqa: E402

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _cell(shape, by_axis, arch="qwen1.5-0.5b", flops=3.1e14,
          nbytes=7.7e11, mesh="32x8", chips=256):
    """A dry-run record as ``launch/dryrun.run_cell`` writes it."""
    return {"arch": arch, "shape": shape, "mesh": mesh, "num_devices": chips,
            "active_params": 4.6e8, "params": 4.6e8, "flops": flops,
            "bytes_accessed": nbytes, "compile_scanned_s": 12.3,
            "cost_source": "traced, every layer",
            "memory": {"temp_size_in_bytes": 2.5e9,
                       "argument_size_in_bytes": 1.25e9},
            "collectives": roofline.collective_bytes(
                [("all-reduce", b / 2, axis) for axis, b in by_axis.items()])}


def test_hw_holds_the_h100_sxm_constants():
    assert HW == {"peak_flops": 989e12, "peak_flops_f32": 67e12,
                  "peak_flops_tf32": 495e12, "hbm_bw": 3.35e12,
                  "nvlink_bw": 450e9, "ib_bw": 50e9}
    assert roofline.LINK_FOR_AXIS == {"model": "nvlink_bw", "data": "ib_bw",
                                      "pod": "ib_bw"}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("axis", ["data", "model", "pod"])
def test_roofline_terms_are_the_references_at_h100_rates(shape, axis):
    cell = _cell(shape, {axis: 3.0e9})
    got = roofline.roofline_terms(cell)
    want = ref_roofline.roofline_terms(cell)
    ref_hw = ref_roofline.HW
    assert set(got) == set(want)
    for key in ("arch", "shape", "mesh", "model_flops", "hlo_flops_global",
                "useful_ratio"):
        assert got[key] == want[key], key
    assert got["compute_s"] * HW["peak_flops"] == pytest.approx(
        want["compute_s"] * ref_hw["peak_flops"], rel=1e-15)
    assert got["memory_s"] * HW["hbm_bw"] == pytest.approx(
        want["memory_s"] * ref_hw["hbm_bw"], rel=1e-15)
    link = HW[roofline.LINK_FOR_AXIS[axis]]
    assert got["collective_s"] * link == pytest.approx(
        want["collective_s"] * ref_hw["ici_bw"], rel=1e-15)
    terms = {k: got[f"{k}_s"] for k in ("compute", "memory", "collective")}
    assert got["bound_s"] == max(terms.values())
    assert got["dominant"] == max(terms, key=terms.get)
    assert got["roofline_fraction"] == pytest.approx(
        got["model_flops"] / (256 * HW["peak_flops"]) / got["bound_s"],
        rel=1e-15)


def test_the_collective_term_sums_each_axis_at_its_link():
    cell = _cell("train_4k", {"model": 9.0e9, "data": 2.0e9, "pod": 1.0e9})
    got = roofline.roofline_terms(cell)
    assert got["collective_s"] == pytest.approx(
        9.0e9 / 450e9 + 3.0e9 / 50e9, rel=1e-15)
    # a record without axes (or an axis of no known link) crosses nodes
    cell["collectives"].pop("by_axis")
    assert roofline.roofline_terms(cell)["collective_s"] == pytest.approx(
        12.0e9 / 50e9, rel=1e-15)


def test_a_skipped_or_empty_cell_has_no_roofline():
    assert roofline.roofline_terms({"skipped": "why"}) is None
    assert roofline.roofline_terms(_cell("train_4k", {}, flops=0)) is None


def test_collective_bytes_follow_the_references_hlo_conventions():
    """The same five collectives as HLO text (the reference parses it) and
    as recorded (op, bytes, axis) records: the same bytes per op kind
    (max of operand and result, all-reduce twice), counts and total."""
    hlo = "\n".join([
        "  %ar = f32[128,256]{1,0} all-reduce(f32[128,256]{1,0} %a), "
        "channel_id=1",
        "  %ag = bf16[64,1024]{1,0} all-gather(bf16[8,1024]{1,0} %b), "
        "dimensions={0}",
        "  %rs = f32[16,512]{1,0} reduce-scatter(f32[128,512]{1,0} %c), "
        "dimensions={0}",
        "  %aa = bf16[32,64]{1,0} all-to-all(bf16[32,64]{1,0} %d), "
        "dimensions={0}",
        "  %cp = f32[1024]{0} collective-permute(f32[1024]{0} %e), "
        "source_target_pairs={{0,1}}",
        "  %ar2 = f32[8]{0} all-reduce(f32[8]{0} %f), channel_id=2",
    ])
    want = ref_roofline.collective_bytes_from_hlo(hlo)
    got = roofline.collective_bytes([
        ("all-reduce", 128 * 256 * 4, "model"),
        ("all-gather", 64 * 1024 * 2, "data"),
        ("reduce-scatter", 128 * 512 * 4, "data"),
        ("all-to-all", 32 * 64 * 2, "model"),
        ("collective-permute", 1024 * 4, "pod"),
        ("all-reduce", 8 * 4, "data")])
    for key in roofline.COLL_OPS + ("total",):
        assert got[key] == want[key], key
    assert got["counts"] == want["counts"]
    assert got["by_axis"] == {"model": 2 * 128 * 256 * 4 + 32 * 64 * 2,
                              "data": 64 * 1024 * 2 + 128 * 512 * 4 + 64,
                              "pod": 1024 * 4}


def _write_cells(tmp_path):
    cells = []
    for i, shape in enumerate(SHAPES[:3]):
        cells.append(_cell(shape, {"data": 1e9 * (i + 1), "model": 4e9},
                           flops=1e14 * (i + 1), nbytes=5e11 / (i + 1)))
    cells.append(_cell("train_4k", {"model": 2e9}, arch="mamba2-130m"))
    for c in cells:
        name = f"{c['arch']}__{c['shape']}__{c['mesh']}.json"
        (tmp_path / name).write_text(json.dumps(c))
    skip = {"arch": "qwen1.5-0.5b", "shape": "long_500k",
            "skipped": "pure full-attention arch — no sub-quadratic path"}
    (tmp_path / "qwen1.5-0.5b__long_500k__skip.json").write_text(
        json.dumps(skip))
    return cells


def test_report_tables_are_the_references_on_the_same_cells(tmp_path):
    """The dry-run table row for row (its header names the port's trace
    time and counts); the roofline table's rows are the port's own
    ``roofline_terms`` in the reference's layout."""
    cells = _write_cells(tmp_path)
    got = report.dryrun_table(report.load_cells(str(tmp_path))).splitlines()
    want = ref_report.dryrun_table(
        ref_report.load_cells(str(tmp_path))).splitlines()
    assert len(got) == len(want) == 2 + len(cells) + 1
    assert got[2:] == want[2:]
    assert got[0].replace("trace (s)", "compile (s)").replace(
        "| TFLOP/dev", "| HLO TFLOP/dev") == want[0]
    rows = report.roofline_table(str(tmp_path)).splitlines()[2:]
    terms = roofline.analyze_dir(str(tmp_path))
    assert len(rows) == len(terms) == len(cells)
    for row, r in zip(rows, terms):
        f = [x.strip() for x in row.strip("|").split("|")]
        assert f[:2] == [r["arch"], r["shape"]]
        assert f[2] == f"{r['compute_s'] * 1e3:.2f}"
        assert f[4] == f"{r['collective_s'] * 1e3:.2f}"
        assert f[5] == f"**{r['dominant']}**"


def test_report_splices_between_the_markers_as_the_reference(tmp_path):
    text = ("# T\n\n### Dry run\n<!-- DRYRUN_TABLE -->\nold\nrows\n\n"
            "### Roofline\n<!-- ROOFLINE_TABLE -->\nold\n\n## Next\nkeep\n")
    for t in ("| a |", "| b |\n| c |"):
        got = report._splice(text, "<!-- DRYRUN_TABLE -->", t)
        assert got == ref_report._splice(text, "<!-- DRYRUN_TABLE -->", t)
        assert got == report._splice(got, "<!-- DRYRUN_TABLE -->", t)
    (tmp_path / "cells").mkdir()
    _write_cells(tmp_path / "cells")
    perf = tmp_path / "PERF.md"
    perf.write_text(text)
    assert report.main(["--dir", str(tmp_path / "cells"), "--perf",
                        str(perf)]) == 0
    out = perf.read_text()
    assert out.startswith("# T\n\n### Dry run\n<!-- DRYRUN_TABLE -->\n\n| arch")
    assert out.endswith("\n## Next\nkeep\n") and "old" not in out
    assert "skipped: pure full-attention" in out


# ------------------------------------------------------------ work counts
def test_work_counts_are_perf_md_section_6s():
    """The bound column's (operations, bytes) at each kernel's timed shape,
    as PERF.md §6 prints them."""
    ops, nbytes = flash_attention_work(4, 32, 8, 4608, 80, torch.bfloat16,
                                       window=4096)
    assert nbytes == 235_929_600 and f"{ops:.3e}" == "4.296e+11"
    assert ops == 4 * 4 * 32 * 80 * 10_487_808
    ops, nbytes = flash_attention_work(4, 32, 8, 8192, 80, torch.bfloat16,
                                       window=4096, backward=True)
    assert nbytes == 671_088_640 and f"{ops:.3e}" == "2.577e+12"
    assert ops == 10 * 4 * 32 * 80 * 25_167_872
    assert rmsnorm_work(18432, 2560, torch.bfloat16)[1] == 188_753_920
    assert rmsnorm_work(32768, 2560, torch.bfloat16, backward=True)[1] == \
        503_336_960
    assert ssd_scan_work(4, 128, 24, 64, 128)[1] == 808_501_248
    assert ssd_scan_work(8, 128, 24, 64, 128, backward=True)[1] == \
        2_422_407_168
    # phi3-mini's and olmoe's prefill rows (4b, 4c)
    assert flash_attention_work(4, 32, 32, 4064, 96, torch.bfloat16)[1] == \
        399_507_456
    assert flash_attention_work(4, 16, 16, 4064, 128,
                                torch.bfloat16)[1] == 266_338_304


@pytest.mark.parametrize("s", [1, 7, 64, 129, 1000, 4608])
def test_causal_pairs_are_the_tile_plans(s):
    for causal, window in ((True, 0), (True, 1), (True, 64), (True, s),
                           (True, 4096), (False, 0)):
        assert causal_pairs(s, causal, window) == \
            flash_pairs(s, causal, window)[0], (s, causal, window)


def _kernels():
    """(name, call, inputs of a small shape) for the three LM kernels."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 16, generator=g)
    sc = torch.rand(16, generator=g) + 0.5
    q = torch.randn(2, 4, 12, 8, generator=g)
    kv = [torch.randn(2, 2, 12, 8, generator=g) for _ in range(2)]
    dec = torch.rand(2, 3, 4, generator=g)
    dbx = torch.randn(2, 3, 4, 5, 6, generator=g)
    return [("rmsnorm", lambda a, b: rmsnorm(a, b), (x, sc),
             lambda: rmsnorm_work(12, 16, torch.float32),
             lambda: rmsnorm_work(12, 16, torch.float32, backward=True)),
            ("flash_attention",
             lambda a, b, c: flash_attention(a, b, c, window=5), (q, *kv),
             lambda: flash_attention_work(2, 4, 2, 12, 8, torch.float32,
                                          window=5),
             lambda: flash_attention_work(2, 4, 2, 12, 8, torch.float32,
                                          window=5, backward=True)),
            ("ssd_scan", lambda a, b: ssd_scan(a, b), (dec, dbx),
             lambda: ssd_scan_work(2, 3, 4, 5, 6),
             lambda: ssd_scan_work(2, 3, 4, 5, 6, backward=True))]


@pytest.mark.parametrize("mode", ["meta", "fake"])
def test_shape_only_route_allocates_outputs_and_counts_the_work(mode):
    """Meta and fake tensors never reach the plain version: outputs of the
    kernel's shapes and dtypes, its forward's work counted, and its
    backward's when a gradient flows."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode()
    plain = {"rmsnorm": rmsnorm_ref,
             "flash_attention": lambda a, b, c: flash_attention_ref(
                 a, b, c, window=5),
             "ssd_scan": ssd_scan_ref}
    for name, call, inputs, fwd, bwd in _kernels():
        want = plain[name](*inputs)
        want = want if isinstance(want, tuple) else (want,)
        if mode == "meta":
            ins = [t.to("meta").requires_grad_() for t in inputs]
        else:
            ins = [fake.from_tensor(t).requires_grad_() for t in inputs]
        with COUNTER.counting():
            out = call(*ins)
            outs = out if isinstance(out, tuple) else (out,)
            assert COUNTER.calls == {name: 1}
            assert (COUNTER.flops[name], COUNTER.bytes[name]) == fwd()
            sum(o.sum() for o in outs).backward()
            assert COUNTER.calls == {name: 1, name + "_bwd": 1}
            assert (COUNTER.flops[name + "_bwd"],
                    COUNTER.bytes[name + "_bwd"]) == bwd()
        for o, w in zip(outs, want):
            assert o.shape == w.shape and o.dtype == w.dtype
            assert o.device.type == "meta" if mode == "meta" else o.is_cpu
        assert all(t.grad is not None and t.grad.shape == t.shape
                   for t in ins)
    assert COUNTER.active is False


def test_counted_route_gives_the_plain_versions_values_and_gradients():
    """While the counter is active a CPU tensor still gets the plain
    version's outputs and gradients, and the kernel's work is counted."""
    for name, call, inputs, fwd, bwd in _kernels():
        a = [t.clone().requires_grad_() for t in inputs]
        b = [t.clone().requires_grad_() for t in inputs]
        want = call(*a)
        with COUNTER.counting():
            got = call(*b)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
        gs = [torch.randn_like(w) for w in want]
        torch.autograd.backward(want, gs)
        with COUNTER.counting():
            torch.autograd.backward(got, gs)
            assert COUNTER.calls == {name + "_bwd": 1}
        for x, y in zip(a, b):
            assert torch.equal(y.grad, x.grad), name
