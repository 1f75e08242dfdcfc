"""Port parity, the LM kernels: the plain PyTorch versions of ``rmsnorm``,
``flash_attention`` and ``ssd_scan`` (what the wrappers run on CPU tensors)
against the reference Pallas kernels in interpret mode, at the reference's
own test shapes and tolerances (``tests/test_kernels.py``), plus GQA with a
sliding window and head dim 80 (h2o-danube-1.8b's)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as ref_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as ref_rmsnorm  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan  # noqa: E402

from repro_torch.kernels import (flash_attention, rmsnorm,  # noqa: E402
                                 ssd_scan)

# the reference's tolerances (tests/test_kernels.py:14-15, :133)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSD_TOL = dict(rtol=1e-6, atol=1e-6)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype`` (both
    round f32 → bf16 to nearest even, so the bits agree)."""
    return jnp.asarray(a, JNP[dtype]), torch.from_numpy(a).to(TORCH[dtype])


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 64, 128), (2, 200, 256), (1, 1, 512),
                                   (3, 70, 128), (2, 9, 768)])
def test_rmsnorm_matches_pallas(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x_np = rng.standard_normal(shape).astype(np.float32)
    scale_np = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    xj, xt = _pair(x_np, dtype)
    want = ref_rmsnorm(xj, jnp.asarray(scale_np), interpret=True,
                       block_rows=64)
    got = rmsnorm(xt, torch.from_numpy(scale_np))
    assert got.dtype == TORCH[dtype] and got.shape == xt.shape
    _close(got, want, TOL[dtype])


# ----------------------------------------------------------- flash attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,d,window", [
    (1, 4, 4, 128, 64, 0),       # MHA
    (2, 4, 2, 256, 64, 0),       # GQA
    (1, 8, 1, 128, 128, 0),      # MQA
    (1, 2, 2, 200, 64, 0),       # non-divisible seq
    (1, 8, 2, 200, 80, 48),      # GQA + window, head dim 80, S > window
])
def test_flash_attention_matches_pallas(b, h, kv, s, d, window, dtype):
    rng = np.random.default_rng(s + d + window)
    qn, kn, vn = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (qn, kn, vn))
    want = ref_flash(qj, kj, vj, causal=True, window=window, interpret=True)
    got = flash_attention(qt, kt, vt, causal=True, window=window)
    assert got.dtype == TORCH[dtype] and got.shape == qt.shape
    _close(got, want, TOL[dtype])


def test_flash_attention_bf16_window_off_the_tile_grid_matches_pallas():
    """bf16 at head dim 80 with a window that is not a multiple of 64 (its
    edge falls inside the kernels' key tiles) and a ragged S: the wrapper
    against ``flash_attention_ref`` and against the Pallas kernel in
    interpret mode, at the reference's bf16 tolerance."""
    from repro_torch.kernels import flash_attention_ref
    rng = np.random.default_rng(333)
    b, h, kv, s, d, window = 1, 4, 2, 333, 80, 100
    qn, kn, vn = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16")
                                    for a in (qn, kn, vn))
    got = flash_attention(qt, kt, vt, causal=True, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    want = flash_attention_ref(qt, kt, vt, causal=True, window=window)
    _close(got, want.to(torch.float32).numpy(), TOL["bfloat16"])
    pallas = ref_flash(qj, kj, vj, causal=True, window=window,
                       interpret=True)
    _close(got, pallas, TOL["bfloat16"])


def test_flash_attention_non_causal_matches_pallas():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
               for _ in range(3))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, interpret=True)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=False)
    _close(got, want, TOL["float32"])


def test_flash_attention_non_causal_window_follows_ref():
    """causal=False with a window: the window is not applied, as in
    ``ref.flash_attention_ref`` (the Pallas kernel skips blocks by the
    window but does not mask inside them)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 160, 80)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 160, 80)).astype(np.float32)
            for _ in range(2))
    want = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False, window=32)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=False, window=32)
    _close(got, want, TOL["float32"])
    full = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal=False)
    assert torch.equal(got, full)


# ----------------------------------------------------------------- ssd scan
@pytest.mark.parametrize("b,c,h,p,n", [(2, 5, 3, 16, 32), (1, 16, 8, 64, 128),
                                       (3, 1, 2, 8, 16)])
def test_ssd_scan_matches_pallas(b, c, h, p, n):
    rng = np.random.default_rng(b * 100 + c)
    dec = rng.uniform(0.3, 0.999, (b, c, h)).astype(np.float32)
    dbx = rng.standard_normal((b, c, h, p, n)).astype(np.float32)
    want_b, want_f = ref_ssd_scan(jnp.asarray(dec), jnp.asarray(dbx),
                                  interpret=True)
    got_b, got_f = ssd_scan(torch.from_numpy(dec), torch.from_numpy(dbx))
    assert got_b.shape == (b, c, h, p, n) and got_f.shape == (b, h, p, n)
    _close(got_b, want_b, SSD_TOL)
    _close(got_f, want_f, SSD_TOL)


# ----------------------------------------------------------------- wrappers
def test_flash_attention_argument_checks_and_routes():
    """What the CUDA kernels refuse raises before any launch (checked here
    on CPU tensors, which the wrapper itself hands to the plain version),
    and the dtype picks the route: bf16 the tensor-core kernel, f32 the
    SIMT kernel."""
    from repro_torch.kernels.flash_attention import _check_args
    q = torch.zeros(1, 4, 8, 80, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 8, 80, dtype=torch.bfloat16)
    assert _check_args(q, kv, kv, 0) == "wgmma_bf16"
    assert _check_args(q.float(), kv.float(), kv.float(), 0) == "simt_f32"
    with pytest.raises(ValueError, match="head dim 96"):
        _check_args(*(torch.zeros(1, 2, 8, 96, dtype=torch.bfloat16),) * 3,
                    0)
    with pytest.raises(ValueError, match="k must be a contiguous"):
        _check_args(q, kv.float(), kv, 0)
    with pytest.raises(ValueError, match="q must be a contiguous"):
        _check_args(q.transpose(2, 3).contiguous().transpose(2, 3), kv, kv,
                    0)
    with pytest.raises(ValueError, match="v must be a contiguous"):
        _check_args(q, kv, kv.transpose(2, 3).contiguous().transpose(2, 3),
                    0)
    with pytest.raises(ValueError, match="do not group"):
        _check_args(q, *(torch.zeros(1, 3, 8, 80, dtype=torch.bfloat16),)
                    * 2, 0)
    with pytest.raises(ValueError, match="window must be"):
        _check_args(q, kv, kv, -1)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flat = torch.zeros(1 + 4 * 8 * 80, dtype=torch.bfloat16)
        _check_args(flat[1:].view(1, 4, 8, 80), *(kv[:, :2],) * 2, 0)



def test_wrappers_take_the_plain_version_only_on_cpu():
    """CPU tensors run the plain versions without counting a launch; a
    tensor on any other non-CUDA device raises instead of falling back."""
    counts = (rmsnorm.launches, flash_attention.launches, ssd_scan.launches)
    x = torch.ones(2, 8)
    rmsnorm(x, torch.ones(8))
    q = torch.ones(1, 2, 4, 64)
    flash_attention(q, q, q)
    ssd_scan(torch.ones(1, 2, 1), torch.ones(1, 2, 1, 2, 2))
    assert (rmsnorm.launches, flash_attention.launches,
            ssd_scan.launches) == counts
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rmsnorm(meta, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_attention(*(torch.empty(1, 2, 4, 64, device="meta"),) * 3)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ssd_scan(torch.empty(1, 2, 1, device="meta"),
                 torch.empty(1, 2, 1, 2, 2, device="meta"))
