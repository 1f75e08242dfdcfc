"""The bf16 flash kernel's tile plan (``flash_tile_plan``, the Python mirror
of ``csrc/flash_attention_sm90.cu``'s loop bounds) against the dense mask of
``flash_attention_ref``: every key tile holding an unmasked (query, key)
pair is visited, only wholly masked tiles are skipped, and a tile is left
unmasked only when none of its pairs is masked.  Then an online softmax that
walks the plan as the kernel does (masking only the planned tiles, P rounded
to bf16) against ``flash_attention_ref``."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    BLOCK_K, BLOCK_Q, flash_attention_ref, flash_mask, flash_pairs,
    flash_tile_plan)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - hypothesis is a test extra
    given = None


def _dense(s, causal, window):
    mask = flash_mask(s, causal, window)
    return torch.ones(s, s, dtype=torch.bool) if mask is None else mask


def _check_plan(s, bq, bk, causal, window):
    mask = _dense(s, causal, window)
    plan = flash_tile_plan(s, bq, bk, causal, window)
    n_kt = -(-s // bk)
    assert len(plan) == -(-s // bq)
    for n, tile in enumerate(plan):
        rows = mask[n * bq:(n + 1) * bq]
        assert 0 <= tile.lo <= tile.hi < n_kt
        assert set(tile.masked) <= set(range(tile.lo, tile.hi + 1))
        for kt in range(n_kt):
            block = rows[:, kt * bk:(kt + 1) * bk]
            visited = tile.lo <= kt <= tile.hi
            # every tile with an unmasked pair is visited; skipped tiles are
            # wholly masked; and no visited tile is wholly masked
            assert visited == bool(block.any()), (n, kt)
            if visited and kt not in tile.masked:
                # unmasked: no masked pair and no key at or past S
                assert (kt + 1) * bk <= s and bool(block.all()), (n, kt)


@pytest.mark.parametrize("s,bq,bk,causal,window", [
    (4608, 128, 128, True, 4096),   # danube's prefill
    (333, 128, 128, True, 100),     # window edge inside a tile, ragged S
    (300, 128, 128, True, 64),      # window < block_k
    (1000, 128, 128, True, 300),    # window not a multiple of the tile
    (200, 128, 128, True, 500),     # window >= S
    (257, 128, 128, True, 0),       # causal, no window
    (300, 128, 128, False, 64),     # causal=False: no window either
    (129, 128, 128, False, 0),
    (1, 128, 128, True, 1),
    (700, 64, 128, True, 256),      # query and key tiles of other sizes
    (700, 128, 64, True, 200),
    # window edges one key either side of a tile boundary
    (700, 128, 128, True, 127), (700, 128, 128, True, 129),
    (700, 128, 128, True, 128), (520, 64, 64, True, 63),
    (520, 64, 64, True, 65), (520, 128, 64, True, 2),
    (900, 128, 128, True, 255), (900, 128, 64, True, 191),
    # S one short of a tile boundary: one key past S in the last tile
    (255, 128, 128, False, 0), (383, 64, 128, False, 0),
])
def test_tile_plan_matches_dense_mask(s, bq, bk, causal, window):
    _check_plan(s, bq, bk, causal, window)


def test_tile_plan_at_danube_visits_the_window_and_masks_its_edges():
    """S=4608, window 4096: a full query tile visits 33 key tiles and masks
    two, the diagonal and the window's lower edge."""
    plan = flash_tile_plan(4608, BLOCK_Q, BLOCK_K, True, 4096)
    assert plan[0] == (0, 0, (0,))
    for n in range(32, 36):
        assert plan[n] == (n - 32, n, (n - 32, n))


@pytest.mark.parametrize("s,causal,window", [
    (4608, True, 4096), (333, True, 100), (300, False, 64), (200, True, 0)])
def test_flash_pairs_counts_the_dense_mask(s, causal, window):
    pairs, visited = flash_pairs(s, causal, window)
    assert pairs == int(_dense(s, causal, window).sum())
    plan = flash_tile_plan(s, BLOCK_Q, BLOCK_K, causal, window)
    assert visited == sum(
        (t.hi - t.lo + 1) * min(BLOCK_Q, s - n * BLOCK_Q) * BLOCK_K
        for n, t in enumerate(plan))


if given is not None:
    @settings(max_examples=60, deadline=None)
    @given(s=st.integers(1, 700),
           window=st.integers(0, 800) | st.builds(
               lambda n, e: max(0, 64 * n + e), st.integers(0, 12),
               st.sampled_from([-1, 0, 1])),
           causal=st.booleans(), bq=st.sampled_from([64, 128]),
           bk=st.sampled_from([64, 128]))
    def test_tile_plan_property(s, window, causal, bq, bk):
        _check_plan(s, bq, bk, causal, window)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _online_by_plan(q, k, v, causal, window, bq=64, bk=64):
    """The kernel's walk over one head: visit the planned key tiles, mask
    only those the plan marks, online softmax with P rounded to bf16."""
    s, d = q.shape
    out = torch.empty(s, d)
    c = 1.0 / math.sqrt(d)
    for n, tile in enumerate(flash_tile_plan(s, bq, bk, causal, window)):
        i = torch.arange(n * bq, min((n + 1) * bq, s))[:, None]
        m = torch.full((len(i), 1), -1e30)
        l = torch.zeros(len(i), 1)
        acc = torch.zeros(len(i), d)
        for kt in range(tile.lo, tile.hi + 1):
            t = torch.arange(kt * bk, (kt + 1) * bk)[None, :]
            kb = torch.zeros(bk, d)     # keys past S arrive as zeros
            vb = torch.zeros(bk, d)
            kb[:max(0, min(bk, s - kt * bk))] = k[kt * bk:(kt + 1) * bk]
            vb[:max(0, min(bk, s - kt * bk))] = v[kt * bk:(kt + 1) * bk]
            sc = q[i[:, 0]] @ kb.T * c
            if kt in tile.masked:
                ok = t < s
                if causal:
                    ok = ok & (t <= i)
                    if window:
                        ok = ok & (t > i - window)
                sc = torch.where(ok, sc, torch.tensor(-1e30))
            m_new = torch.maximum(m, sc.max(1, keepdim=True).values)
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(1, keepdim=True)
            acc = alpha * acc + _bf16(p) @ vb
            m = m_new
        out[i[:, 0]] = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out


@pytest.mark.parametrize("s,causal,window", [
    (333, True, 100), (200, True, 0), (260, True, 37), (150, False, 64)])
def test_online_softmax_over_the_plan_matches_ref(s, causal, window):
    rng = np.random.default_rng(s + window)
    q, k, v = (torch.from_numpy(_bf16(torch.from_numpy(
        rng.standard_normal((s, 80)).astype(np.float32))).numpy())
        for _ in range(3))
    want = flash_attention_ref(q[None, None], k[None, None], v[None, None],
                               causal=causal, window=window)[0, 0]
    got = _online_by_plan(q, k, v, causal, window)
    # P in bf16, as the kernel's P·V product takes it: the reference's bf16
    # tolerance (tests/test_kernels.py:14-15)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)
