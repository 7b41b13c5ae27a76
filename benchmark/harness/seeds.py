"""Streams of random numbers from the run's ``--seed``: one named stream
for each use, so that adding a use leaves the others as they were."""

from __future__ import annotations

import zlib

import numpy as np


def np_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64, zlib.crc32(stream.encode())]))


def torch_seed(seed: int, stream: str = "weights") -> int:
    return int(np_rng(seed, stream).integers(2 ** 62))

