"""Device selection shared by the port's entry points."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "seeded_generator"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names an absent card.

    Entry points run on the card unless the caller passes ``device="cpu"``
    (the CPU tests do); they never fall back to the CPU on their own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' "
                         f"or 'cpu'")
    return dev


def seeded_generator(words, device) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``words``: two
    lists differing anywhere give unrelated streams."""
    state = np.random.SeedSequence(list(words)).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g
