"""Port parity, the async server and the AOT cache:
``repro_torch.api.AsyncPlacementServer`` against the reference's on one
checkpoint (the reference fits it, both packages load it): the same
placements, failures and ``requests``/``failed``/``recompiles`` on one
stream; then the port's own cases (futures and isolation, full and
deadline batches, the default tenant and its errors, two tenants, a
decode error settling its own batch, close draining then refusing) and the
AOT cache (the file store, a fresh service and a fresh process with no
cold bucket, a corrupt blob or one from another torch or kernel build
counted as a load failure and stored again).  Every wait has a timeout;
no assertion rests on a sleep."""
import json
import os
import subprocess
import sys
import textwrap
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as refapi  # noqa: E402
from repro.core import CompGraph as RefGraph  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.graphs import build_corpus as ref_build_corpus  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.api import aot as aotmod  # noqa: E402
from repro_torch.core import CompGraph, HSDAGConfig  # noqa: E402
from repro_torch.graphs import build_corpus  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

#: the reference's serving tests' policy (``tests/test_server.py``)
WL = "synthetic:family=mixed:count=4:size=12:seed=6"
#: graph indices of the stream; -1 is the out-of-vocabulary graph
STREAM = [0, 1, 2, 3, 0, -1, 3, 0, 2, 1, 0, 3]
WAIT = 120          # seconds any future may take
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _oov_graph(cls):
    """An op type no synthetic family emits: fails vocab validation."""
    g = cls("oov")
    g.add_op("in", "Parameter", output_shape=(1, 4), flops=0, bytes_out=16)
    g.add_op("sm", "Softmax", ["in"], (1, 4), flops=10, bytes_out=16)
    return g


@pytest.fixture(scope="module")
def policy(tmp_path_factory):
    """The reference fits ``tests/test_server.py``'s session and saves it;
    the port loads it on the CPU."""
    d = str(tmp_path_factory.mktemp("policy"))
    ref = refapi.PlacementSession(refapi.PlacementSpec(
        workload=WL, mode="corpus",
        config=RefConfig(num_devices=2, hidden_channel=16, max_episodes=1,
                         update_timestep=3, batch_chains=2),
        max_buckets=2, graphs_per_episode=2))
    ref.fit()
    ref.save(d)
    ref_graphs, graphs = ref_build_corpus(WL), build_corpus(WL)
    return SimpleNamespace(
        dir=d, port=api.PlacementSession.load(d, device="cpu"),
        ref_graphs=ref_graphs, graphs=graphs,
        ref_stream=[ref_graphs[i] if i >= 0 else _oov_graph(RefGraph)
                    for i in STREAM],
        stream=[graphs[i] if i >= 0 else _oov_graph(CompGraph)
                for i in STREAM])


def _service(policy, **kw):
    return api.PlacementService(policy.port, **kw)


# ------------------------------------------------------- against the reference
def test_both_servers_serve_one_stream_alike(policy):
    kw = dict(batch_slots=2, max_delay_ms=2.0, size_granularity=8)
    with refapi.AsyncPlacementServer(**kw) as ref_server, \
            api.AsyncPlacementServer(device="cpu", **kw) as server:
        ref_server.register(policy.dir)
        server.register(policy.dir)
        want = ref_server.place_many(policy.ref_stream,
                                     return_exceptions=True, timeout=WAIT)
        got = server.place_many(policy.stream, return_exceptions=True,
                                timeout=WAIT)
        for i, (w, g) in enumerate(zip(want, got)):
            if isinstance(w, Exception):
                assert type(g) is type(w) and str(g) == str(w), i
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        ref_stats, stats = ref_server.stats(), server.stats()
    for key in ("requests", "failed", "recompiles", "aot_decodes", "tenants",
                "queued"):
        assert stats[key] == ref_stats[key], key
    assert (stats["requests"], stats["failed"], stats["recompiles"]) \
        == (11, 1, 3)


# ------------------------------------------------------------- the port's own
def test_futures_and_isolation(policy):
    graphs = policy.graphs
    with api.AsyncPlacementServer(batch_slots=2, max_delay_ms=2.0,
                                  device="cpu") as server:
        tenant = server.register(policy.port)
        futs = [server.submit(g, tenant=tenant) for g in graphs]
        bad = server.submit(_oov_graph(CompGraph), tenant=tenant)
        assert bad.done()                  # failed on the caller's thread
        with pytest.raises(ValueError, match="Softmax"):
            bad.result(timeout=WAIT)
        for g, f in zip(graphs, futs):
            np.testing.assert_array_equal(f.result(timeout=WAIT),
                                          policy.port.place(g))
        stats = server.stats()
        assert (stats["requests"], stats["failed"], stats["queued"]) \
            == (len(graphs), 1, 0)
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(graphs[0], tenant=tenant)


@pytest.mark.parametrize("case", ["full", "deadline"])
def test_batches_flush_full_or_at_the_deadline(policy, case):
    """One bucket (granularity 64): four requests under a deadline far
    beyond the submit loop make one full batch; one request alone under a
    1-ms deadline is flushed by it."""
    n, delay = (4, 60_000.0) if case == "full" else (1, 1.0)
    with api.AsyncPlacementServer(batch_slots=4, max_delay_ms=delay,
                                  size_granularity=64,
                                  device="cpu") as server:
        server.register(policy.port)
        futs = [server.submit(g) for g in policy.graphs[:n]]
        out = [f.result(timeout=WAIT) for f in futs]
        full, deadline = server.batches_full, server.batches_deadline
    assert (full, deadline) == ((1, 0) if case == "full" else (0, 1))
    for g, p in zip(policy.graphs, out):
        np.testing.assert_array_equal(p, policy.port.place(g))


def test_place_many_and_the_default_tenant(policy):
    graphs = policy.graphs
    with api.AsyncPlacementServer(batch_slots=2, max_delay_ms=1.0,
                                  device="cpu") as server:
        with pytest.raises(ValueError, match="tenant= is required"):
            server.submit(graphs[0])          # no tenant registered
        server.register(policy.port)
        out = server.place_many(graphs, timeout=WAIT)
        for g, p in zip(graphs, out):
            np.testing.assert_array_equal(p, policy.port.place(g))
        mixed = server.place_many([graphs[0], _oov_graph(CompGraph)],
                                  return_exceptions=True, timeout=WAIT)
        np.testing.assert_array_equal(mixed[0], out[0])
        assert isinstance(mixed[1], ValueError)
        with pytest.raises(ValueError, match="Softmax"):
            server.place_many([graphs[0], _oov_graph(CompGraph)],
                              timeout=WAIT)
        with pytest.raises(KeyError, match="unknown tenant"):
            server.submit(graphs[0], tenant="nope")


def test_two_tenants(policy):
    """Two policies behind one server: spec-hash ids, each tenant's
    placements its own service's, cold buckets ≤ (tenant, bucket) pairs."""
    other = api.PlacementSession(api.PlacementSpec(
        workload=WL, mode="corpus",
        config=HSDAGConfig(num_devices=2, hidden_channel=8, max_episodes=1,
                           update_timestep=3, batch_chains=2),
        max_buckets=2, graphs_per_episode=2), device="cpu")
    other.fit(rng=0)
    graphs = policy.graphs
    with api.AsyncPlacementServer(batch_slots=2, max_delay_ms=1.0,
                                  size_granularity=64,
                                  device="cpu") as server:
        t_a = server.register(policy.port)
        t_b = server.register(other)
        assert (t_a, t_b) == (policy.port.spec.spec_hash(),
                              other.spec.spec_hash())
        assert server.register(policy.port) == t_a      # idempotent
        assert server.tenants() == [t_a, t_b]
        with pytest.raises(ValueError, match="tenant= is required when 2"):
            server.submit(graphs[0])
        out_a = server.place_many(graphs, tenant=t_a, timeout=WAIT)
        out_b = server.place_many(graphs, tenant=t_b, timeout=WAIT)
        for g, pa, pb in zip(graphs, out_a, out_b):
            np.testing.assert_array_equal(pa, policy.port.place(g))
            np.testing.assert_array_equal(pb, other.place(g))
        stats = server.stats()
    assert stats["tenants"] == 2 and set(stats["per_tenant"]) == {t_a, t_b}
    assert stats["requests"] == 2 * len(graphs)
    assert stats["recompiles"] == 2       # one bucket a tenant


def test_a_decode_error_settles_its_own_batch(policy):
    """The failing tenant's futures carry the decode's error; the other
    tenant's batch is served."""
    broken = _service(policy, batch_slots=2, size_granularity=64)

    def fail(bucket, members, out):
        raise RuntimeError("decode failed")

    broken.decode_bucket = fail
    with api.AsyncPlacementServer(batch_slots=2, max_delay_ms=1.0,
                                  size_granularity=64,
                                  device="cpu") as server:
        server.register(broken, tenant="broken")
        server.register(policy.port, tenant="ok")
        bad = [server.submit(g, tenant="broken") for g in policy.graphs[:2]]
        good = server.submit(policy.graphs[0], tenant="ok")
        for f in bad:
            with pytest.raises(RuntimeError, match="decode failed"):
                f.result(timeout=WAIT)
        np.testing.assert_array_equal(good.result(timeout=WAIT),
                                      policy.port.place(policy.graphs[0]))


def test_close_drains_then_refuses(policy):
    server = api.AsyncPlacementServer(batch_slots=8, max_delay_ms=60_000.0,
                                      size_granularity=64, device="cpu")
    server.register(policy.port)
    futs = [server.submit(g) for g in policy.graphs]
    server.close(timeout=WAIT)
    assert not server._flusher.is_alive()
    for g, f in zip(policy.graphs, futs):
        assert f.done()
        np.testing.assert_array_equal(f.result(timeout=0),
                                      policy.port.place(g))
    assert server.batches_deadline == 1 and server.stats()["queued"] == 0
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(policy.graphs[0])
    with pytest.raises(RuntimeError, match="closed"):
        server.register(policy.port)
    server.close()                        # idempotent


def test_concurrent_clients_lose_no_count(policy):
    """Sixteen client threads, more than the cores, submit valid and
    invalid requests at once with a short switch interval: every future
    settles right and no counter loses an update."""
    graphs, n_threads, per_thread = policy.graphs, 16, 6
    results, errors = {}, []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with api.AsyncPlacementServer(batch_slots=4, max_delay_ms=1.0,
                                      size_granularity=64,
                                      device="cpu") as server:
            server.register(policy.port)

            def client(k):
                try:
                    futs = [(j, server.submit(
                        graphs[(k + j) % 4] if (k + j) % 3
                        else _oov_graph(CompGraph)))
                        for j in range(per_thread)]
                    results[k] = [(j, f.exception(timeout=WAIT)
                                   or f.result(timeout=0)) for j, f in futs]
                except Exception as e:          # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT)
            assert not any(t.is_alive() for t in threads) and not errors
            stats = server.stats()
    finally:
        sys.setswitchinterval(interval)
    bad = sum((k + j) % 3 == 0 for k in range(n_threads)
              for j in range(per_thread))
    total = n_threads * per_thread
    assert (stats["requests"], stats["failed"]) == (total - bad, bad)
    tenant = stats["per_tenant"][policy.port.spec.spec_hash()]
    assert (tenant["cache_misses"], tenant["cache_hits"]) \
        == (4, total - bad - 4)
    want = [policy.port.place(g) for g in graphs]
    for k, rows in results.items():
        for j, got in rows:
            if (k + j) % 3:
                np.testing.assert_array_equal(got, want[(k + j) % 4])
            else:
                assert isinstance(got, ValueError)


# -------------------------------------------------------------- the AOT cache
def test_the_aot_file_store(tmp_path):
    cache = api.AotExecutableCache(str(tmp_path / "aot"))
    assert cache.load("h1", (16, 32), 2) is None
    assert cache.stats()["aot_misses"] == 1
    path = cache.store("h1", (16, 32), 2, b"blob-a")
    assert path.endswith(os.path.join("h1", "greedy_v1_16v32e2g.ptaot"))
    cache.store("h1", (32, 32), 2, b"blob-b")
    cache.store("h2", (16, 32), 2, b"blob-c")
    # a reference blob in the same directory is not the port's
    with open(tmp_path / "aot" / "h1" / "greedy_v1_16v32e2g.jaxaot",
              "wb") as f:
        f.write(b"jax")
    assert cache.load("h1", (16, 32), 2) == b"blob-a"
    assert cache.load("h1", (16, 32), 4) is None   # another decode width
    assert len(cache.entries()) == 3 and len(cache.entries("h1")) == 2
    assert cache.clear("h1") == 2
    assert cache.entries("h1") == [] and cache.load("h1", (16, 32), 2) is None
    cache.store("h2", (48, 48), 2, b"")            # a torn write's survivor
    assert cache.load("h2", (48, 48), 2) is None
    assert cache.stats() == {"aot_hits": 1, "aot_misses": 4,
                             "aot_stores": 4, "aot_load_failures": 1,
                             "aot_entries": 2}
    assert not [f for f in os.listdir(tmp_path / "aot" / "h2")
                if f.endswith(".tmp")]


def test_the_blob_names_this_process():
    doc = json.loads(aotmod.greedy_blob("h", (16, 32), 2, "cpu"))
    assert doc == {"format": "repro_torch.greedy_decode.v1",
                   "torch": torch.__version__, "cuda": torch.version.cuda,
                   "device": "cpu", "capability": None, "spec_hash": "h",
                   "bucket": [16, 32], "batch_slots": 2, "libraries": {}}
    aotmod.preload_greedy(aotmod.greedy_blob("h", (16, 32), 2, "cpu"),
                          "h", (16, 32), 2, "cpu")
    with pytest.raises(ValueError, match="bucket"):
        aotmod.preload_greedy(aotmod.greedy_blob("h", (16, 48), 2, "cpu"),
                              "h", (16, 32), 2, "cpu")


def test_an_unbuilt_library_is_not_built_by_a_preload(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(FileNotFoundError, match="not built"):
        _build.library("gcn_spmm", build=False)
    assert list(tmp_path.iterdir()) == []


def test_a_fresh_service_has_no_cold_bucket(policy, tmp_path):
    aot = api.AotExecutableCache(str(tmp_path / "aot"))
    warm = _service(policy, batch_slots=2, size_granularity=8, aot_cache=aot)
    want = warm.place_many(policy.graphs)
    assert warm.stats()["aot_stores"] == len(warm.shape_keys_seen) == 3
    fresh = _service(policy, batch_slots=2, size_granularity=8,
                     aot_cache=aot)
    got = fresh.place_many(policy.graphs)
    assert len(fresh.shape_keys_seen) == 0 and fresh.aot_decodes == 3
    assert fresh.stats()["aot_hits"] == 3
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def _rewrite(doc, case):
    doc = dict(doc)
    if case == "torch":
        doc["torch"] = doc["torch"] + ".other"
    elif case == "library":
        doc["libraries"] = {"gcn_spmm": "libgcn_spmm-0000000000000000.so"}
    elif case == "device":
        doc["device"], doc["capability"] = "NVIDIA H100 80GB HBM3", [9, 0]
    return json.dumps(doc).encode()


@pytest.mark.parametrize("case", ["corrupt", "empty", "torch", "library",
                                  "device"])
def test_a_bad_blob_is_a_load_failure_and_is_stored_again(policy, tmp_path,
                                                          case):
    aot = api.AotExecutableCache(str(tmp_path / "aot"))
    warm = _service(policy, batch_slots=2, size_granularity=32,
                    aot_cache=aot)
    want = warm.place_many(policy.graphs)
    (rel,) = aot.entries()
    path = os.path.join(aot.directory, rel)
    with open(path, "rb") as f:
        doc = json.loads(f.read())
    blob = {"corrupt": b"not a blob", "empty": b""}.get(case)
    with open(path, "wb") as f:
        f.write(blob if blob is not None else _rewrite(doc, case))
    fresh = _service(policy, batch_slots=2, size_granularity=32,
                     aot_cache=api.AotExecutableCache(aot.directory))
    got = fresh.place_many(policy.graphs)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    stats = fresh.stats()
    assert stats["aot_load_failures"] == stats["shape_keys_seen"] == 1
    assert stats["aot_stores"] == 1 and stats["aot_decodes"] == 0
    with open(path, "rb") as f:
        assert json.loads(f.read()) == doc            # stored again
    again = _service(policy, batch_slots=2, size_granularity=32,
                     aot_cache=aot.directory)
    again.place_many(policy.graphs)
    assert again.stats()["shape_keys_seen"] == 0


_FRESH_PROCESS = textwrap.dedent("""
    import sys, numpy as np
    from repro_torch.api import PlacementService
    from repro_torch.graphs import build_corpus
    ckpt, aot_dir, expected, workload = sys.argv[1:5]
    service = PlacementService(ckpt, batch_slots=2, size_granularity=32,
                               aot_cache=aot_dir, device="cpu")
    data = np.load(expected)
    got = service.place_many(build_corpus(workload))
    assert len(service.shape_keys_seen) == 0, service.stats()
    assert service.aot_decodes > 0 and service.stats()["aot_hits"] > 0
    for i, p in enumerate(got):
        np.testing.assert_array_equal(p, data["p%d" % i])
    print("FRESH_PROCESS_OK cold=0 aot_decodes=%d" % service.aot_decodes)
""")


def test_a_fresh_process_has_no_cold_bucket(policy, tmp_path):
    aot_dir = str(tmp_path / "aot")
    warm = _service(policy, batch_slots=2, size_granularity=32,
                    aot_cache=aot_dir)
    expected = warm.place_many(policy.graphs)
    assert warm.stats()["aot_stores"] > 0
    npz = str(tmp_path / "expected.npz")
    np.savez(npz, **{f"p{i}": p for i, p in enumerate(expected)})
    script = tmp_path / "fresh.py"
    script.write_text(_FRESH_PROCESS)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, str(script), policy.dir, aot_dir, npz, WL],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "FRESH_PROCESS_OK cold=0" in proc.stdout
