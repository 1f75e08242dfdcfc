"""Port parity, checkpoints: the port's ``save_policy`` read by the
reference's ``restore_policy`` and the reference's read by the port's
``load_policy`` (leaves, feature layout, manifest, greedy placements), and
the manager's format, atomic rename, keep-k and errors."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.checkpoint import policy_feature_config as ref_policy_fc  # noqa: E402,E501
from repro.checkpoint import restore_policy as ref_restore  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.core import MultiGraphTrainer as RefTrainer  # noqa: E402
from repro.core import features as reffeat  # noqa: E402
from repro.core import paper_platform as ref_paper  # noqa: E402

from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    params_to_numpy, policy_feature_config,
                                    policy_manifest, restore_policy,
                                    save_policy)
from repro_torch.core import (FeatureConfig, HSDAGConfig,  # noqa: E402
                              MultiGraphTrainer, extract_features,
                              paper_platform, shared_feature_config)

from conftest import make_diamond, random_dag  # noqa: E402

CFG = dict(num_devices=2, hidden_channel=16, batch_chains=2, max_episodes=1,
           update_timestep=3)


def _graphs():
    rng = np.random.default_rng(10)
    return [make_diamond(), random_dag(rng, 9, p=0.3)]


@pytest.fixture(scope="module")
def trained():
    tr = MultiGraphTrainer(HSDAGConfig(engine="level", **CFG), device="cpu")
    tr.train(_graphs(), platform=paper_platform())
    return tr


def _leaves_equal(mine, want):
    a, b = jax.tree.leaves(mine), jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_the_reference_restores_the_ports_checkpoint(trained, tmp_path):
    trained.save_policy(str(tmp_path), step=5, meta={"note": np.int64(3)})
    ref = RefTrainer(RefConfig(engine="level", **CFG))
    fc = reffeat.FeatureConfig(**dataclasses.asdict(trained.feature_config))
    ref.init(jax.random.PRNGKey(123),
             reffeat.extract_features(_graphs()[0], fc))
    assert ref.load_policy(str(tmp_path)) == 5
    _leaves_equal(jax.tree.map(np.asarray, ref.params),
                  params_to_numpy(trained.policy))
    assert ref.feature_config == fc
    params, ref_fc, step, manifest = ref_restore(str(tmp_path), ref.params)
    assert step == 5 and ref_fc == fc
    assert manifest["engine"] == "level" and manifest["note"] == 3
    assert RefConfig(**manifest["config"]) == RefConfig(engine="level", **CFG)
    assert ref_policy_fc(str(tmp_path)) == fc
    unseen = random_dag(np.random.default_rng(4), 13, p=0.2)
    p1, l1 = trained.evaluate_zero_shot(unseen, platform=paper_platform())
    p2, l2 = ref.evaluate_zero_shot(unseen, platform=ref_paper())
    np.testing.assert_array_equal(p1, p2)
    assert l1 == pytest.approx(l2, rel=1e-12)


def test_the_port_loads_the_references_checkpoint(tmp_path):
    graphs = _graphs()
    ref = RefTrainer(RefConfig(**CFG))
    ref.train(graphs, platform=ref_paper(), rng=jax.random.PRNGKey(0))
    ref.save_policy(str(tmp_path), step=7)
    fc = policy_feature_config(str(tmp_path))
    assert dataclasses.asdict(fc) == dataclasses.asdict(ref.feature_config)
    tr = MultiGraphTrainer(HSDAGConfig(**CFG), device="cpu")
    tr.init(extract_features(graphs[0], fc))
    assert tr.load_policy(str(tmp_path)) == 7
    assert tr.feature_config == fc
    _leaves_equal(params_to_numpy(tr.policy),
                  jax.tree.map(np.asarray, ref.params))
    for g in graphs + [random_dag(np.random.default_rng(5), 17, p=0.2)]:
        p1, l1 = tr.evaluate_zero_shot(g, platform=paper_platform())
        p2, l2 = ref.evaluate_zero_shot(g, platform=ref_paper())
        np.testing.assert_array_equal(p1, p2)
        assert l1 == pytest.approx(l2, rel=1e-12)
    assert policy_manifest(str(tmp_path))["engine"] == "auto"
    # the optimizer starts afresh on the restored weights
    tr.train(graphs, platform=paper_platform())


def test_the_manager_writes_the_references_format(tmp_path):
    tree = {"enc": {"trans": [{"w": np.ones((2, 3), np.float32),
                               "b": np.zeros(3, np.float32)}]},
            "gpn": {"phi": [{"w": np.arange(4, dtype=np.float32)}]}}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, tree, {"step_note": step})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    with np.load(tmp_path / "step_0000000003" / "state.npz") as d:
        assert sorted(d.files) == ["enc/trans/0/b", "enc/trans/0/w",
                                   "gpn/phi/0/w"]
    with open(tmp_path / "step_0000000003" / "manifest.json") as f:
        assert json.load(f)["step_note"] == 3
    ref = RefManager(str(tmp_path))
    assert ref.all_steps() == [2, 3]
    _leaves_equal(ref.restore(3, tree), tree)
    _leaves_equal(mgr.restore(3), tree)
    _leaves_equal(mgr.restore(2, tree), tree)
    # a crashed save's .tmp is removed, and never read as a step
    os.makedirs(tmp_path / "step_0000000009.tmp")
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    assert not (tmp_path / "step_0000000009.tmp").exists()
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(3, {**tree, "pol": {"mlp": [{"w": np.ones(1)}]}})
    with pytest.raises(FileNotFoundError):
        restore_policy(str(tmp_path / "empty"))


def test_restore_checks_the_vocabulary_and_the_engine(trained, tmp_path):
    save_policy(str(tmp_path / "plain"), trained.policy)
    with pytest.raises(ValueError, match="no feature_config"):
        restore_policy(str(tmp_path / "plain"), trained.policy,
                       graphs=_graphs())
    trained.save_policy(str(tmp_path / "ok"))
    conv = random_dag(np.random.default_rng(1), 40, p=0.1)
    narrow = shared_feature_config([make_diamond()], FeatureConfig(d_pos=8))
    save_policy(str(tmp_path / "narrow"), trained.policy,
                feature_config=narrow)
    restore_policy(str(tmp_path / "ok"), trained.policy, graphs=_graphs())
    with pytest.raises(ValueError, match="Convolution"):
        restore_policy(str(tmp_path / "narrow"), trained.policy,
                       graphs=[conv])
    trained.save_policy(str(tmp_path / "odd"), meta={"engine": "tpu_sim"})
    with pytest.raises(ValueError, match="tpu_sim"):
        trained.load_policy(str(tmp_path / "odd"))
    fresh = MultiGraphTrainer(HSDAGConfig(**CFG), device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        fresh.load_policy(str(tmp_path / "ok"))
