"""The reference's search-quality record, ``tools/reference_search_spread.json``,
that ``chip_smoke.py`` holds the port's search against: three paper graphs ×
two engines × 12 seeds of finite best latencies, searched with the config
``chip_smoke.py`` searches the port with."""
import importlib.util
import json
import math
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_spread_has_every_graph_engine_and_seed():
    smoke = _chip_smoke()
    with open(smoke.SPREAD_JSON) as f:
        doc = json.load(f)
    assert doc["config"] == smoke.SPREAD_CONFIG
    assert doc["seeds"] == list(range(12))
    assert doc["platform"] == "paper_platform()"
    assert doc["jax_version"] and doc["date"]
    assert set(doc["results"]) == {"inception_v3", "resnet50", "bert_base"}
    for name, row in doc["results"].items():
        assert set(row) == {"auto", "level"}, name
        for engine, by_seed in row.items():
            assert set(by_seed) == {str(s) for s in doc["seeds"]}
            lat = list(by_seed.values())
            assert all(math.isfinite(x) and 0 < x < 1 for x in lat), (
                name, engine)
