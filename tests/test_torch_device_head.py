"""Port parity, the device head (``head="device"``): its logits, log-prob
and entropy under no mask, a binding capacity mask and the all-infeasible
fallback; a rollout window on a fleet with binding capacities, scored by the
scan reward (masked, as the reference masks it) and by the level reward
(unmasked, as the reference leaves it), with its Eq.-14 gradients; the
greedy decode; the converter; and the reference's error paths — with the
same weights and the reference's own draws fed to the port."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import platforms as ref_platforms  # noqa: E402
from repro.checkpoint import save_policy as ref_save_policy  # noqa: E402
from repro.core import HSDAG as RefHSDAG  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.core import policy as ref_policy  # noqa: E402
from repro.core.costmodel import Platform as RefPlatform  # noqa: E402
from repro.core.reinforce import step_weights  # noqa: E402
from repro.core.sim import RewardPipeline as RefPipeline  # noqa: E402

from repro_torch import platforms  # noqa: E402
from repro_torch.checkpoint import (load_reference_policy,  # noqa: E402
                                    params_from_numpy, params_to_numpy,
                                    tree_from_tensors)
from repro_torch.core import (HSDAG, HSDAGConfig, extract_features,  # noqa: E402
                              simulate)
from repro_torch.core.costmodel import Platform  # noqa: E402
from repro_torch.core.policy import DevicePolicy, policy_apply  # noqa: E402
from repro_torch.core.sim import RewardPipeline  # noqa: E402

from conftest import random_dag  # noqa: E402
from test_torch_grad_precision import F32_RTOL  # noqa: E402
from test_torch_hsdag import TOL, _assert_trees_close, _noise  # noqa: E402

B, T, HIDDEN, D = 2, 3, 16, 4
#: per-device capacities of the test fleet: nodes of more than 2048 bytes
#: never fit device 1, of more than 1024 never device 3
CAPACITIES = (16e9, 2048.0, 16e9, 1024.0)


def _fleet(mod, platform_cls):
    """``ring(4)`` with the capacities above (the builders give every device
    one capacity, which cannot make the mask bind)."""
    base = mod.ring(devices=D)
    devices = tuple(dataclasses.replace(d, mem_capacity=c)
                    for d, c in zip(base.devices, CAPACITIES))
    return platform_cls(devices, base.link_bw, base.link_latency,
                        coords=base.coords)


def _pair(arrays, seed=0, **kw):
    """The reference agent with fresh weights bound to the fleet, and the
    port's agent holding the same weights, bound to its copy."""
    cfg = RefConfig(hidden_channel=HIDDEN, batch_chains=B, update_timestep=T,
                    max_episodes=1, head="device", num_devices=D, **kw)
    ref = RefHSDAG(cfg)
    ref.init(jax.random.PRNGKey(seed), arrays)
    ref.bind_platform(_fleet(ref_platforms, RefPlatform))
    agent = HSDAG(HSDAGConfig.from_json(cfg.to_json()), device="cpu")
    agent.load_params(jax.tree.map(np.asarray, ref.params))
    agent.bind_platform(_fleet(platforms, Platform))
    return ref, agent


@pytest.fixture(scope="module")
def graph():
    g = random_dag(np.random.default_rng(4), 24)
    return g, extract_features(g)


# ----------------------------------------------------------- policy head
def _head_pair(slots):
    key = jax.random.PRNGKey(3)
    feats = ref_platforms.device_feature_table(
        ref_platforms.nvlink_island(islands=2, gpus_per_island=2))
    params = ref_policy.policy_init(key, HIDDEN, D, head="device",
                                    dev_feat_dim=feats.shape[1])
    pol = DevicePolicy(HIDDEN, feats.shape[1])
    with torch.no_grad():          # the reference's (in, out) weights
        for name, p in pol.named_parameters():
            part, i, leaf = name.split(".")
            arr = np.asarray(params[part][int(i)][
                {"weight": "w", "bias": "b"}[leaf]])
            p.copy_(torch.as_tensor(arr.T.copy() if leaf == "weight"
                                    else arr.copy()))
    pooled = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                        (slots, HIDDEN)))
    return params, pol, feats, pooled


@pytest.mark.parametrize("case", ["no_mask", "binding", "infeasible"])
@pytest.mark.parametrize("temperature", [None, 0.7])
def test_device_head_matches_the_reference(case, temperature):
    """Logits, log-prob, entropy and the sampled and greedy placements of
    the device head on clustered slots (labels merge nodes), under no mask,
    a mask that binds (a cluster may only use the devices all its members
    fit on) and one no device satisfies (the unmasked fallback)."""
    slots = 6
    params, pol, feats, pooled = _head_pair(slots)
    labels = np.array([0, 0, 2, 3, 3, 3], np.int32)
    active = np.array([1, 0, 1, 1, 0, 0], bool)
    mask = None
    if case == "binding":
        mask = np.ones((slots, D), bool)
        mask[0, 1] = mask[1, 2] = False        # cluster 0: devices 0 and 3
        mask[3:, 0] = mask[4, 3] = False       # cluster 3: devices 1 and 2
        mask[2, :3] = False                    # slot 2: device 3 only
    elif case == "infeasible":
        mask = np.zeros((slots, D), bool)
    key = jax.random.PRNGKey(5)
    temp = None if temperature is None else jnp.float32(temperature)
    for greedy in (False, True):
        want = ref_policy.policy_apply(params, jnp.asarray(pooled),
                                       jnp.asarray(active),
                                       jnp.asarray(labels), key,
                                       greedy=greedy, temperature=temp,
                                       dev_feats=jnp.asarray(feats),
                                       action_mask=mask)
        gumbel = torch.as_tensor(np.array(
            jax.random.gumbel(key, (slots, D))))[None]
        with torch.no_grad():
            mine = policy_apply(
                pol, torch.as_tensor(pooled)[None],
                torch.as_tensor(active)[None],
                torch.as_tensor(labels, dtype=torch.long)[None],
                greedy=greedy, gumbel=None if greedy else gumbel,
                temperature=(None if temperature is None
                             else torch.tensor([temperature])),
                dev_feats=torch.as_tensor(feats),
                action_mask=None if mask is None else torch.as_tensor(mask))
        np.testing.assert_allclose(mine.logits[0].numpy(),
                                   np.asarray(want.logits), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(mine.coarse_placement[0].numpy(),
                                      np.asarray(want.coarse_placement))
        np.testing.assert_array_equal(mine.fine_placement[0].numpy(),
                                      np.asarray(want.fine_placement))
        for got, ref in ((mine.logp, want.logp),
                         (mine.entropy, want.entropy)):
            assert np.isfinite(float(got[0]))
            np.testing.assert_allclose(float(got[0]), float(ref), rtol=TOL,
                                       atol=TOL)
    if case == "binding":
        assert mask[np.arange(slots), mine.fine_placement[0].numpy()].all()


# --------------------------------------------------- a window and its replay
@pytest.mark.parametrize("backend", ["scan", "level"])
def test_a_window_on_a_capacity_bound_fleet_matches_the_reference(graph,
                                                                  backend):
    """One window of the device head on the fleet, the reference's draws
    fed to the port: placements and groups exact, rewards and states within
    1e-5, the Eq.-14 gradient within the f32 tolerance.  The scan reward
    masks sampling and replay by ``fit_ok`` (every sample fits); the level
    reward, which the reference scores outside its rollout, masks neither.
    A replay without the sampling pass's mask gives another gradient."""
    g, arrays = graph
    ref, agent = _pair(arrays)
    ref_plat = _fleet(ref_platforms, RefPlatform)
    plat = _fleet(platforms, Platform)
    ref_pipe = RefPipeline.from_platform(g, ref_plat, backend)
    pipe = RewardPipeline.from_platform(g, plat, backend, device="cpu")
    assert pipe.fused == ref_pipe.fused == (backend == "scan")
    fit_ok = np.asarray(pipe.prep.arrays.fit_ok)
    assert not fit_ok[:, 1].all() and not fit_ok[:, 3].all()
    assert fit_ok[:, 0].all() and fit_ok[:, 2].all()
    ref_engine = ref._engine_single(arrays, ref_pipe)
    engine = agent.rollout_engine(arrays, pipeline=pipe)
    assert (engine.action_mask is not None) == (backend == "scan")

    rng = jax.random.PRNGKey(1)
    rngs = jnp.stack([rng, jax.random.fold_in(rng, 1)])[None]
    x0 = jnp.asarray(arrays.x)
    ref_z = jnp.broadcast_to(x0, (1, B) + x0.shape)
    (ref_z1, _, keys, ref_fines, ref_ng, ref_rew, ref_lat) = \
        ref_engine.rollout_window(ref.params, ref_z, rngs, num_steps=T,
                                  start_first=True)
    if ref_pipe.fused:
        ref_rew = np.asarray(ref_rew, np.float64)[:, 0]
        ref_lat = np.asarray(ref_lat, np.float64)[:, 0]
    else:
        ref_rew, ref_lat = ref_pipe.score_window(np.asarray(ref_fines)[:, 0])

    z = engine.x0.expand(B, *engine.x0.shape)
    noise = _noise(np.asarray(keys)[:, 0], arrays, D)
    z1, record, fines, ngroups = engine.rollout_window(
        z, num_steps=T, start_first=True, noise=noise)
    rewards, latencies = pipe.score_window(fines)
    np.testing.assert_array_equal(fines.numpy(), np.asarray(ref_fines)[:, 0])
    np.testing.assert_array_equal(ngroups.numpy(), np.asarray(ref_ng)[:, 0])
    np.testing.assert_allclose(rewards, ref_rew, rtol=TOL)
    np.testing.assert_allclose(latencies, ref_lat, rtol=TOL)
    np.testing.assert_allclose(z1.numpy(), np.asarray(ref_z1)[0], rtol=TOL,
                               atol=TOL)
    fits = fit_ok[np.arange(g.num_nodes), fines.numpy()].all()
    if backend == "scan":
        assert fits
    else:
        assert not fits

    ref_w = step_weights(ref_rew.T, ref.cfg.gamma).T
    ref_grads = ref_engine.window_grads(
        ref.params, ref_z, keys, jnp.asarray(ref_w)[:, None], num_steps=T,
        start_first=True)
    w = torch.as_tensor(step_weights(rewards.T, agent.cfg.gamma).T.copy())
    grads = engine.window_grads(z, record, w, start_first=True)
    names = [n for n, _ in agent.policy.named_parameters()]
    mine = tree_from_tensors(names, grads)
    want = jax.tree.map(np.asarray, ref_grads)
    # The last device-embedding bias adds the same term to every logit of a
    # slot, which the softmax ignores: its exact gradient is 0, and each
    # side holds f32 cancellation noise there, so it is held at 0 on the
    # scale of its layer's weight gradient.
    scale = float(np.abs(want["pol"]["dev"][-1]["w"]).max())
    for tree in (mine, want):
        assert np.abs(tree["pol"]["dev"][-1].pop("b")).max() \
            <= F32_RTOL * scale
    _assert_trees_close(mine, want, F32_RTOL, "device-head window gradient")
    if backend == "scan":
        engine.action_mask = None
        unmasked = engine.window_grads(z, record, w, start_first=True)
        assert max(float((a - b).abs().max())
                   for a, b in zip(grads, unmasked)) > 1e-3


def test_a_device_head_population_search_runs_end_to_end(graph):
    """``search`` with the device head and a population (a cull every
    window, a greedy restart every second) on the capacity-bound fleet:
    the best placement fits and its latency is the host scheduler's."""
    g, arrays = graph
    plat = _fleet(platforms, Platform)
    agent = HSDAG(HSDAGConfig(hidden_channel=HIDDEN, batch_chains=4,
                              update_timestep=T, max_episodes=2,
                              head="device", num_devices=D), device="cpu")
    res = agent.search(g, arrays, platform=plat,
                       population={"cull_every": 1,
                                   "greedy_restart_every": 2})
    assert all(h["culled"] for h in res.history)
    fit_ok = RewardPipeline.from_platform(g, plat, "scan",
                                          device="cpu").fit_ok
    assert fit_ok[np.arange(g.num_nodes), res.best_placement].all()
    host = simulate(g, res.best_placement, plat).latency
    assert res.best_latency == pytest.approx(host, rel=TOL)


# ------------------------------------------- decode, converter, error paths
def test_greedy_place_matches_the_reference(graph):
    """The greedy decode on the bound fleet: the reference's placement
    exactly (neither side masks it), on a fleet of another size too."""
    g, arrays = graph
    ref, agent = _pair(arrays, seed=2)
    np.testing.assert_array_equal(agent.place(arrays), ref.place(arrays))
    for mod, target in ((ref_platforms, ref), (platforms, agent)):
        target.bind_platform(mod.torus(rows=2, cols=3))
    p = agent.place(arrays)
    np.testing.assert_array_equal(p, ref.place(arrays))
    assert p.max() < 6


def test_converter_round_trips_a_device_head_checkpoint(graph, tmp_path):
    g, arrays = graph
    ref, _ = _pair(arrays, seed=1)
    tree = jax.tree.map(np.asarray, ref.params)
    policy = params_from_numpy(tree)
    assert isinstance(policy.pol, DevicePolicy)
    back = params_to_numpy(policy)
    assert set(back["pol"]) == {"mlp", "dev"}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.tobytes() == b.tobytes()
    ref_save_policy(str(tmp_path), ref.params, step=3,
                    meta={"config": ref.cfg.to_json()})
    loaded, manifest = load_reference_policy(str(tmp_path))
    agent = HSDAG(HSDAGConfig.from_json(manifest["config"]), device="cpu")
    agent.load_params(loaded)
    agent.bind_platform(_fleet(platforms, Platform))
    np.testing.assert_array_equal(agent.place(arrays), ref.place(arrays))


def test_error_paths_are_the_references(graph):
    """No platform (a bare ``reward_fn``), ``engine="scalar"``, and
    ``place()`` with no fleet bound raise the reference's errors."""
    g, arrays = graph
    cfg = RefConfig(hidden_channel=HIDDEN, batch_chains=1, head="device",
                    num_devices=D, max_episodes=1, update_timestep=1)
    cases = [
        (dict(reward_fn=lambda p: (1.0, 1.0)), None),
        (dict(engine="scalar"), "fleet"),
    ]
    for kw, fleet in cases:
        messages = []
        for cls, mod, plat_cls in ((RefHSDAG, ref_platforms, RefPlatform),
                                   (HSDAG, platforms, Platform)):
            agent = (cls(cfg) if cls is RefHSDAG else
                     cls(HSDAGConfig.from_json(cfg.to_json()), device="cpu"))
            source = dict(kw)
            if fleet:
                source["platform"] = _fleet(mod, plat_cls)
            with pytest.raises(ValueError) as info:
                agent.search(g, arrays, **source)
            messages.append(str(info.value))
        assert messages[0] == messages[1]
    messages = []
    for agent in (RefHSDAG(cfg), HSDAG(HSDAGConfig.from_json(cfg.to_json()),
                                       device="cpu")):
        if isinstance(agent, RefHSDAG):
            agent.init(jax.random.PRNGKey(0), arrays)
        else:
            agent.init(arrays)
        with pytest.raises(ValueError) as info:
            agent.place(arrays)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
