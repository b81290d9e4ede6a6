"""The one traffic generator: a traffic file's parameters and a seed in,
the texts a cell serves out.

A traffic file (benchmark/traffic/<name>.json) names its texts (a file
beside it) and, for the stream loop, the batch size. Every text a run
serves is drawn with replacement from those texts: the window's from
one stream of the seed, the warm-up's from another, so the window
serves batches the warm-up never saw. The same seed gives the same
texts in the same order; another seed, other draws.
"""

from __future__ import annotations

import json
import os

import numpy as np

# The streams of a seed, one for each use.
WINDOW = 0      # the texts served from the warm-up's end on
KEEP = 1        # which answers are kept for the check
CHECK = 2       # which texts the reference speaks
WARM = 3        # the texts served in the warm-up


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of its own for each use of the seed. Any whole number
    is a seed."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def texts(traffic: dict, traffic_dir: str) -> list:
    with open(os.path.join(traffic_dir, traffic["texts"]),
              encoding="utf-8") as f:
        return [u["text"] for u in json.load(f)["utterances"]]


def draws(traffic: dict, traffic_dir: str, seed: int, stream: int):
    """Endless items drawn with replacement from the texts by the seed's
    `stream`: for the stream loop batches of `batch` texts, for the call
    loop one text each."""
    base = texts(traffic, traffic_dir)
    g = rng(seed, stream)
    if traffic["loop"] != "stream":
        while True:
            yield base[int(g.integers(len(base)))]
    size = int(traffic["batch"])
    while True:
        yield [base[i] for i in g.integers(0, len(base), size)]
