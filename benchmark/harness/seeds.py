"""Seeds derived from the run's ``--seed``: the same seed gives the same weights,
inputs and samples, whatever its size (any whole number up to 2**63)."""

from __future__ import annotations

import hashlib
import random

import torch


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the stream named by ``keys`` under ``seed``."""
    text = ":".join(str(k) for k in (int(seed), *keys)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


def rng(seed: int, *keys) -> random.Random:
    return random.Random(sub_seed(seed, *keys))
