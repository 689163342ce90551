"""The one traffic generator: a closed loop's calls, read from a
``traffic/<name>.json`` file and a seed.

The sizes (each row's word count and frame length) come in ``pool`` sets
of one batch each, drawn from the file's ``sizes_seed``, the same for
every run seed, so that every seed does the same work; call n takes set
n mod ``pool``, in an order drawn from the run's seed. The rows' order,
the words and the action classes of call n are drawn from the run's seed
and n, so that no prompt is sent twice in a window. Kinds:

  text    captions ``a person`` + words of ``motion_words.txt`` + ``.``;
          word counts log-normal (``median``, ``sigma``) cut to [min, max];
          frame lengths uniform over [min, max]
  action  class ids uniform over the configuration's classes; every clip
          ``frames`` long

A mix may also state ``cpu_threads``, the intra-op CPU threads its serving
loop runs with (a deployment setting the harness applies after set-up;
without it the process keeps PyTorch's own number). A call is {"set",
"texts" or "classes", "lengths"}; the latents and masks
on the device are made by the harness from the same seed and n. Warm-up
calls come from a stream of their own, one for each set.
"""
from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOW, WARM = 0, 1


def vocabulary() -> list:
    with open(os.path.join(HERE, "motion_words.txt")) as f:
        return [w for w in f.read().split() if w]


def _sizes(spec: dict) -> tuple:
    """(word counts or None, frame lengths), [pool, batch] each, from the
    file's own seed."""
    P, B = spec["pool"], spec["batch"]
    rng = np.random.default_rng(spec["sizes_seed"])
    if spec["kind"] == "action":
        return None, np.full((P, B), spec["frames"], np.int64)
    w = spec["words"]
    words = np.exp(np.log(w["median"])
                   + w["sigma"] * rng.standard_normal(P * B))
    words = np.clip(np.rint(words), w["min"], w["max"]).astype(np.int64)
    fr = spec["frames"]
    frames = rng.integers(fr["min"], fr["max"] + 1, P * B)
    return words.reshape(P, B), frames.reshape(P, B)


class Mix:
    """The calls of one traffic file for one seed."""

    def __init__(self, spec: dict, seed: int, n_classes: int = 0):
        if spec["kind"] not in ("text", "action"):
            raise ValueError(f"unknown traffic kind {spec['kind']!r}")
        self.spec, self.n_classes = spec, n_classes
        self.seed = int(seed) % 2 ** 64
        self.words, self.frames = _sizes(spec)
        self.order = np.random.default_rng(
            [self.seed, 0x7a11]).permutation(spec["pool"])
        self.vocab = vocabulary()

    def set_of(self, n: int) -> int:
        """The set of sizes call n of the window takes."""
        return int(self.order[n % len(self.order)])

    def call(self, n: int, stream: int = WINDOW) -> dict:
        """Call n of the window (or, with ``stream=WARM``, the warm-up
        call of set n)."""
        p = self.set_of(n) if stream == WINDOW else int(n)
        rng = np.random.default_rng([self.seed, 0x7a11, stream, int(n)])
        rows = rng.permutation(self.frames.shape[1])
        out = {"set": p, "lengths": self.frames[p, rows]}
        if self.spec["kind"] == "text":
            counts = self.words[p, rows] - 2
            ids = rng.integers(0, len(self.vocab), int(counts.sum()))
            words = [self.vocab[i] for i in ids.tolist()]
            ends = np.cumsum(counts).tolist()
            out["texts"] = ["a person " + " ".join(words[e - k: e]) + "."
                            for k, e in zip(counts.tolist(), ends)]
        else:
            out["classes"] = rng.integers(0, self.n_classes, len(rows))
        return out
