"""Weights and seeded inputs the benchmark makes and hands to both sides.

Every weight comes from one flat buffer per type, drawn N(0, 1) in a
single call of a generator on the device, each leaf a view of it scaled by
its own spread (or set to its constant).  The program gets them as its
parameters; the reference draws them again from the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

TAGS = {"weights": 1, "prompts": 2, "tokens": 3, "batches": 4,
        "arrivals": 5, "sample": 6, "check": 7}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one kind of input, from the run's seed."""
    ss = np.random.SeedSequence([seed % 2 ** 64, TAGS[tag]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def draw(leaves: list, seed: int, device, model_dtype: torch.dtype) -> dict:
    """{name: tensor} for `leaves` ((name, shape, type, std) as the
    reference lists them), on `device`."""
    dtypes = {"model": model_dtype, "float32": torch.float32}
    gen = generator(seed, "weights", device)
    out = {}
    for key, dt in dtypes.items():
        mine = [lf for lf in leaves if lf[2] == key]
        n = sum(int(np.prod(shape)) for _, shape, _, _ in mine)
        if not n:
            continue
        flat = torch.empty(n, dtype=dt, device=device).normal_(generator=gen)
        at = 0
        for name, shape, _, std in mine:
            size = int(np.prod(shape))
            view = flat[at:at + size].view(shape)
            at += size
            if std is None:
                view.fill_(1.0)
            else:
                view.mul_(std)
            out[name] = view
    return {name: out[name] for name, *_ in leaves}


def tokens(seed: int, tag: str, shape: tuple, vocab: int,
           device) -> torch.Tensor:
    """Uniform token ids in [0, vocab), int64, drawn on `device`."""
    return torch.randint(0, vocab, shape, generator=generator(seed, tag, device),
                         device=device)
