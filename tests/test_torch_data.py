"""Port parity, the token pipeline: ``repro_torch.data.SyntheticTokens``
against the reference's ``repro.data.SyntheticTokens`` on the same
``DataConfig``s — every batch bit for bit (the same numpy generators draw
both), the rows ``_gen`` makes for a slice of the batch, and the tensors'
dtype and device."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticTokens as RefSyntheticTokens  # noqa: E402

from repro_torch.data import DataConfig, SyntheticTokens  # noqa: E402

CONFIGS = [dict(vocab_size=101, seq_len=32, global_batch=4, seed=7),
           dict(vocab_size=128, seq_len=16, global_batch=4, seed=11),
           dict(vocab_size=50280, seq_len=64, global_batch=2, seed=11,
                repeat_p=0.5, repeat_window=4)]


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("step", [0, 3, 17])
def test_batches_match_the_reference_bitwise(kw, step):
    want = RefSyntheticTokens(RefDataConfig(**kw)).batch(step)
    got = SyntheticTokens(DataConfig(**kw), device="cpu").batch(step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32
        assert got[key].device.type == "cpu"
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_rows_of_a_slice_are_the_whole_batch_rows():
    """A rank making rows [lo, hi) gets those rows of the global batch."""
    cfg = DataConfig(**CONFIGS[0])
    src = SyntheticTokens(cfg, device="cpu")
    whole = src._gen(5, 0, cfg.global_batch)
    np.testing.assert_array_equal(src._gen(5, 1, 3), whole[1:3])
    ref = RefSyntheticTokens(RefDataConfig(**CONFIGS[0]))
    np.testing.assert_array_equal(ref._gen(5, 1, 3), whole[1:3])


def test_labels_are_shifted_tokens_and_steps_differ():
    src = SyntheticTokens(DataConfig(**CONFIGS[0]), device="cpu")
    a, b = src.batch(0), src.batch(1)
    np.testing.assert_array_equal(a["tokens"][:, 1:].numpy(),
                                  a["labels"][:, :-1].numpy())
    assert not torch.equal(a["tokens"], b["tokens"])
    it = iter(src)
    assert torch.equal(next(it)["tokens"], a["tokens"])
    assert torch.equal(next(it)["labels"], b["labels"])
