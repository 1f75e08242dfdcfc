"""The port's threefry stream (``repro_torch.core.prng``) against
``jax.random``, and the port's ``HSDAG.init`` against the reference's: the
weights a search for seed ``s`` starts from are the reference's, bit for
bit, for both encoders and both heads."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HSDAG as RefHSDAG  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402

from repro_torch.checkpoint import params_to_numpy  # noqa: E402
from repro_torch.core import HSDAG, HSDAGConfig, extract_features  # noqa: E402
from repro_torch.core import prng  # noqa: E402

from conftest import random_dag  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 11, 2 ** 31 + 3])
def test_key_and_split_are_jax_random(seed):
    k, kj = prng.key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(k, np.asarray(kj))
    for n in (2, 3, 7):
        np.testing.assert_array_equal(prng.split(k, n),
                                      np.asarray(jax.random.split(kj, n)))
    # a split of a split: the keys the initialisers walk down
    np.testing.assert_array_equal(
        prng.split(prng.split(k)[1], 3),
        np.asarray(jax.random.split(jax.random.split(kj)[1], 3)))


@pytest.mark.parametrize("shape", [(1,), (3,), (4, 5), (128, 128), (12, 7),
                                   (64, 1)])
def test_uniform_is_jax_random_uniform_bitwise(shape):
    for seed in (0, 5):
        k = prng.split(prng.key(seed), 4)[3]
        kj = jax.random.split(jax.random.PRNGKey(seed), 4)[3]
        lim = np.sqrt(np.float32(6.0 / (shape[0] + shape[-1])))
        for lo, hi in ((-lim, lim), (0.0, 1.0), (-2.5, 0.75)):
            mine = prng.uniform(k, shape, lo, hi)
            want = np.asarray(jax.random.uniform(kj, shape, jnp.float32,
                                                 lo, hi))
            assert mine.dtype == np.float32 and mine.shape == shape
            assert mine.tobytes() == want.tobytes(), (shape, lo, hi)


@pytest.fixture(scope="module")
def arrays():
    return extract_features(random_dag(np.random.default_rng(2), 20))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gnn_model", ["gcn", "sage"])
@pytest.mark.parametrize("head", ["dense", "device"])
def test_init_is_the_reference_init_bitwise(arrays, seed, gnn_model, head):
    """``HSDAG(cfg).init`` holds the reference's
    ``init(split(PRNGKey(seed))[1])``: every leaf, every bit."""
    kw = dict(hidden_channel=16, seed=seed, gnn_model=gnn_model, head=head,
              num_devices=4 if head == "device" else 2)
    ref = RefHSDAG(RefConfig(**kw))
    want = ref.init(jax.random.split(jax.random.PRNGKey(seed))[1], arrays)
    agent = HSDAG(HSDAGConfig(**kw), device="cpu")
    mine = params_to_numpy(agent.init(arrays))
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    mine_leaves = jax.tree_util.tree_leaves_with_path(mine)
    assert [jax.tree_util.keystr(p) for p, _ in mine_leaves] == \
        [jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (path, a), (_, b) in zip(mine_leaves, want_leaves):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), jax.tree_util.keystr(path)


@pytest.mark.parametrize("shape", [(1,), (4, 5), (128, 512), (230, 512),
                                   (64, 1)])
def test_normal_is_jax_random_normal_bitwise(shape):
    """XLA's float32 ``erf_inv`` with its own ``log1p`` and ``log``: every
    draw bit for bit, over both of ``erf_inv``'s branches and both of
    ``log1p``'s."""
    for seed in (0, 7, 2 ** 31 + 3):
        k = prng.split(prng.key(seed), 4)[2]
        mine = prng.normal(k, shape)
        ref = np.asarray(jax.random.normal(
            jax.random.split(jax.random.PRNGKey(seed), 4)[2], shape))
        assert mine.dtype == np.float32 and mine.shape == shape
        np.testing.assert_array_equal(mine.view(np.uint32),
                                      ref.view(np.uint32))
