"""``mx.random`` seeding (counterpart of ``mxnet_tpu/random.py`` and
``_rng.py``).

The JAX package threads stateless keys; the port draws from explicit
``torch.Generator`` objects instead. The same seed gives different
numbers in the two packages (threefry vs. Philox / Mersenne Twister), so
tests that compare them make their inputs with numpy.
"""
from __future__ import annotations

import torch

__all__ = ["generator", "seed"]


def generator(seed_state: int, device="cpu") -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with
    ``seed_state`` — what initializers and tests draw from. Drawing on
    the CPU generator and copying to the card gives the same weights on
    every device."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed_state))
    return g


def seed(seed_state: int) -> None:
    """ref: mx.random.seed — seeds PyTorch's default generators, which
    initializers use when they are given no generator."""
    torch.manual_seed(int(seed_state))
