"""How far the Eq.-14 window gradient of each side sits from a float64
replay, on three random DAGs.

One window is sampled by the reference and replayed by the port with the
reference's draws and the labels and actions they gave: in float32, and in
float64 (the policy, the features, the masks and the weights cast to f64).
The float64 gradient stands for the exact one, and both float32 gradients
are measured against it, as the largest error of a leaf over the leaf's
largest entry.

What the measurement showed (and these tests hold): the port's policy head
once took ``logits - logsumexp(logits)``, whose gradient rounds
``exp(logits - lse)`` at the logits' magnitude; for a slot nearly certain of
its device that swamps ``1 - p``, and the port's float32 gradient sat 1.5e-4
(seed 1) and 7.4e-3 (seed 2) from float64 while the reference's sat at
1.0e-5 and 1.0e-4.  With ``log_softmax`` the port's sits at 1.3e-5, 4.0e-6
and 5.4e-5 (seeds 0, 1, 2) and the reference's at 1.2e-5, 1.0e-5 and
1.0e-4: both are float32 rounding, and the two gradients differ by at most
1.5e-4 of a leaf (seed 2, the GPN's φ).  A window of four chains sampled at
population temperatures (seed 0) puts both at 8.1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HSDAG as RefHSDAG  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.core import paper_platform as ref_paper  # noqa: E402
from repro.core.reinforce import step_weights  # noqa: E402
from repro.core.sim import RewardPipeline as RefPipeline  # noqa: E402
from repro.core.train import PopulationConfig as RefPopulation  # noqa: E402

from repro_torch.checkpoint import tree_from_tensors  # noqa: E402
from repro_torch.core import HSDAG, HSDAGConfig, extract_features  # noqa: E402

from conftest import random_dag  # noqa: E402
from test_torch_hsdag import _noise  # noqa: E402

T, HIDDEN = 3, 16
#: the port's float32 gradient may sit at most this many times the
#: reference's distance from float64 (both are rounding; before the fix the
#: port's sat 7x and 72x further on seeds 1 and 2)
DISTANCE_RATIO = 2.0
#: float32 against float32, per leaf: the two sides' measured distances
#: from float64 added and rounded up — 1.0e-4 and 5.4e-5 at worst, 8.1e-5
#: each at population temperatures.  The parity tests of the search's
#: other paths hold their gradients to it.
F32_RTOL = 2e-4


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float64)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _distance(mine, exact):
    """Per leaf: max |mine − exact| / max |exact|."""
    return {k: float(np.abs(mine[k] - v).max()
                     / max(float(np.abs(v).max()), 1e-30))
            for k, v in exact.items()}


@pytest.fixture(scope="module",
                params=[(0, False), (1, False), (2, False), (0, True)],
                ids=["seed0", "seed1", "seed2", "seed0-temperatures"])
def grads(request):
    """The reference's f32 gradient and the port's f32 and f64 gradients of
    one window on ``random_dag`` seed ``request.param[0]``: two chains, or
    four sampled at a population's temperatures."""
    seed, tempered = request.param
    B = 4 if tempered else 2
    g = random_dag(np.random.default_rng(seed), 24)
    arrays = extract_features(g)
    ref = RefHSDAG(RefConfig(hidden_channel=HIDDEN, batch_chains=B,
                             update_timestep=T, engine="level",
                             max_episodes=1))
    params = ref.init(jax.random.PRNGKey(0), arrays)
    agent = HSDAG(HSDAGConfig.from_json(ref.cfg.to_json()), device="cpu")
    agent.load_params(jax.tree.map(np.asarray, params))

    pipe = RefPipeline.from_platform(g, ref_paper(), "level")
    popcfg = RefPopulation() if tempered else None
    engine_ref = ref._engine_single(arrays, pipe, popcfg)
    rng = jax.random.PRNGKey(1)
    rngs = jnp.stack([rng] + [jax.random.fold_in(rng, b)
                              for b in range(1, B)])[None]
    x0 = jnp.asarray(arrays.x)
    z_ref = jnp.broadcast_to(x0, (1, B) + x0.shape)
    temps = None
    if tempered:
        pop = engine_ref.init_population(jax.random.PRNGKey(5),
                                         num_chains=B)
        out = engine_ref.rollout_window_pop(ref.params, z_ref, rngs, pop,
                                            num_steps=T, start_first=True)
        keys, fines = out[3], out[4]
        temps = torch.tensor(np.asarray(pop.temperature)[0])
    else:
        _, _, keys, fines, _, _, _ = engine_ref.rollout_window(
            ref.params, z_ref, rngs, num_steps=T, start_first=True)
    rewards, _ = pipe.score_window(np.asarray(fines)[:, 0])
    w = step_weights(rewards.T, ref.cfg.gamma).T
    if tempered:
        ref_g = engine_ref.window_grads_pop(
            ref.params, z_ref, keys, jnp.asarray(w)[:, None],
            pop.temperature, num_steps=T, start_first=True)
    else:
        ref_g = engine_ref.window_grads(ref.params, z_ref, keys,
                                        jnp.asarray(w)[:, None],
                                        num_steps=T, start_first=True)

    engine = agent.rollout_engine(arrays)
    z0 = engine.x0.expand(B, *engine.x0.shape)
    _, record, port_fines, _ = engine.rollout_window(
        z0, num_steps=T, start_first=True,
        noise=_noise(np.asarray(keys)[:, 0], arrays, 2), temperature=temps)
    np.testing.assert_array_equal(port_fines.numpy(),
                                  np.asarray(fines)[:, 0])
    names = [n for n, _ in agent.policy.named_parameters()]
    g32 = engine.window_grads(z0, record, torch.as_tensor(w.copy()),
                              start_first=True)
    agent.policy.double()
    engine.x0 = engine.x0.double()
    g64 = engine.window_grads(
        engine.x0.expand(B, *engine.x0.shape),
        record._replace(keep=record.keep.double(),
                        temperature=None if temps is None
                        else temps.double()),
        torch.as_tensor(w.astype(np.float64)), start_first=True)
    return dict(ref=_leaves(jax.tree.map(np.asarray, ref_g)),
                port=_leaves(tree_from_tensors(names, g32)),
                exact=_leaves(tree_from_tensors(names, g64)))


def test_the_port_f32_gradient_is_no_further_from_f64_than_the_reference(
        grads):
    port = max(_distance(grads["port"], grads["exact"]).values())
    ref = max(_distance(grads["ref"], grads["exact"]).values())
    assert port <= DISTANCE_RATIO * ref, (port, ref)


def test_the_f32_gradients_agree_leaf_by_leaf(grads):
    errs = _distance(grads["port"], grads["ref"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= F32_RTOL, (worst, errs[worst])
