"""The traffic generator: a seed repeats its calls, another seed draws
others, no prompt repeats inside a run, and every seed does the same
work."""
import numpy as np
import pytest

from benchmark.core import HERE, load_json
from benchmark.reference import text
from benchmark.traffic import generator

MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


def summary(calls):
    return [(b.get("texts"), list(b["lengths"]),
             None if "classes" not in b else list(b["classes"]))
            for b in calls]


def calls(spec, seed, n):
    mix = generator.Mix(spec, seed, 12)
    return [mix.call(i) for i in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_seed_repeats_and_differs(mix):
    spec = load_json(HERE / "traffic" / f"{mix}.json")
    big = 2 ** 31 + 977
    P = spec["pool"]
    a, b = calls(spec, big, 2 * P), calls(spec, big, 2 * P)
    c = calls(spec, big + 1, 2 * P)
    assert summary(a) == summary(b)
    assert summary(a) != summary(c)
    assert all(len(x["lengths"]) == spec["batch"] for x in a)
    # call n and call n + pool take the same sizes and send other prompts
    for x, y in zip(a[:P], a[P:]):
        assert x["set"] == y["set"]
        assert sorted(x["lengths"]) == sorted(y["lengths"])
        assert summary([x]) != summary([y])
    warm = generator.Mix(spec, big, 12).call(0, generator.WARM)
    assert all(summary([warm]) != summary([x]) for x in a)


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_does_the_same_work(mix):
    """The multiset of (word count, frames) pairs of each set of sizes,
    and so each call's text bucket, is the same for every seed and every
    call of a set; only the order and the words differ."""
    spec = load_json(HERE / "traffic" / f"{mix}.json")

    def work(seed):
        out = []
        for b in calls(spec, seed, 2 * spec["pool"]):
            words = ([len(t.split()) for t in b["texts"]] if "texts" in b
                     else [0] * len(b["lengths"]))
            bucket = (text.tokenize(b["texts"], [16, 24, 32, 48, 64]).shape[1]
                      if "texts" in b else 0)
            out.append((b["set"], bucket,
                        sorted(zip(words, b["lengths"].tolist()))))
        return sorted(out)

    assert work(1) == work(2 ** 40 + 3)


def test_text_mix_shapes():
    spec = load_json(HERE / "traffic" / "text_b128.json")
    pool = calls(spec, 9, spec["pool"])
    words = np.array([len(t.split()) for b in pool for t in b["texts"]])
    frames = np.concatenate([b["lengths"] for b in pool])
    assert words.min() >= 3 and words.max() <= 60
    assert 10 <= np.median(words) <= 14
    assert frames.min() >= 40 and frames.max() <= 196
    vocab = set(generator.vocabulary()) | {"a", "person"}
    assert all(w.rstrip(".") in vocab for b in pool for t in b["texts"]
               for w in t.split())
