"""The one traffic generator: the seed fixes the texts drawn, another
seed draws others, and the warm-up's draws are not the window's."""

import itertools
import os
from collections import Counter

from conftest import ROOT

from benchmark import generator
from benchmark.harness import load_json

TRAFFIC = os.path.join(ROOT, "benchmark", "traffic")


def _draws(name, seed, n, stream=generator.WINDOW):
    traffic = load_json(os.path.join(TRAFFIC, name + ".json"))
    return list(itertools.islice(
        generator.draws(traffic, TRAFFIC, seed, stream), n))


def test_same_seed_same_texts_other_seed_others():
    big = 2**31 + 12345
    for name in ("batch", "sentence"):
        a, b, c = (_draws(name, big, 20), _draws(name, big, 20),
                   _draws(name, 7, 20))
        assert a == b
        assert a != c
        assert _draws(name, big, 20, generator.WARM) != a


def test_batch_draws_shape():
    """Batches of 128 texts drawn with replacement: every corpus text
    comes, in the share of the corpus's 120 utterances that it holds
    (some texts are spoken at several speeds in the upstream script),
    and a batch repeats texts."""
    batches = _draws("batch", 3, 60)
    assert all(len(b) == 128 for b in batches)
    texts = generator.texts(load_json(os.path.join(TRAFFIC, "batch.json")),
                            TRAFFIC)
    assert len(texts) == 120
    counts = Counter(t for b in batches for t in b)
    assert set(counts) == set(texts)
    share = Counter(texts)
    for text, n in counts.items():
        want = 60 * 128 * share[text] / 120
        assert abs(n - want) < 0.5 * want, text
    assert any(len(set(b)) < len(b) for b in batches)
