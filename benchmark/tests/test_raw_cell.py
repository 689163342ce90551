"""The raw-motion cell (``raw_b32``, family ``mld_raw``) at a tiny size on
the CPU, through the unchanged harness from files: a sound run is correct
traced and untraced, each planted fault and the control are not, and the
family's counts of the full-size call hold by hand."""
import json

import pytest
import torch

from benchmark import core
from benchmark.core import HERE, load_json
from benchmark.families import mld_raw
from benchmark.reference import weights as wts
from benchmark.tests import tiny
from mld_tpu_torch.models.denoiser import RawMotionDenoiser
from mld_tpu_torch.models.mld import MLD

CELL = "raw_b32"


def raw_home(tmp, batch=4):
    """A tiny home of the raw cell, its schedule cut to 10 steps."""
    home = tiny.make_home(tmp, cells=(CELL,), batch=batch)
    path = home / "configs" / "novae_humanml3d.json"
    conf = json.loads(path.read_text())
    conf["model"]["scheduler"]["num_train_timesteps"] = 10
    path.write_text(json.dumps(conf))
    return home


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    return raw_home(tmp_path_factory.mktemp("raw"))


def run(home, seed=5, trace=False):
    return core.execute(CELL, seed, 0.2, trace, "cpu", home=home)


def test_sound_runs_are_correct(home):
    res = run(home, 2 ** 31 + 17)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"motions_per_s", "call_ms_p95",
                                   "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    traced = run(home, 12, trace=True)
    assert traced["correct"], traced["checks"]
    # on the CPU: no device lane, so no roofline and no device idle
    assert {"raw_mfu", "raw_step_host_us", "raw_cast_mb"} <= set(
        traced["metrics"])


def noise_skipped(monkeypatch):
    """One step's noise drawn and not added."""
    orig = MLD._step_noise

    def skip(self, shape, generator, dev, step_noise, i):
        noise = orig(self, shape, generator, dev, step_noise, i)
        return torch.zeros_like(noise) if i == 3 else noise
    monkeypatch.setattr(MLD, "_step_noise", skip)


def cfg_swapped(monkeypatch):
    """The CFG halves swapped where the condition is made."""
    orig = MLD.condition_embedding

    def swapped(self, cond):
        out = orig(self, cond)
        return torch.cat(out.chunk(2)[::-1])
    monkeypatch.setattr(MLD, "condition_embedding", swapped)


def other_generator(monkeypatch):
    """The loop draws from a generator of another seed."""
    orig = MLD.generate_feats

    def other(self, cond, mask, *, generator=None, init_latents=None,
              step_noise=None):
        g = torch.Generator(device=generator.device)
        g.manual_seed(generator.initial_seed() + 1)
        return orig(self, cond, mask, generator=g, init_latents=init_latents,
                    step_noise=step_noise)
    monkeypatch.setattr(MLD, "generate_feats", other)


def unmasked_features(monkeypatch):
    """The loop's padded frames handed on to the joints."""
    def generate_feats(self, cond, mask, *, generator=None,
                       init_latents=None, step_noise=None):
        return self.diffusion_reverse(self.condition_embedding(cond),
                                      generator, init_latents, mask,
                                      step_noise)
    monkeypatch.setattr(MLD, "generate_feats", generate_feats)


def joints_scaled(monkeypatch):
    orig = MLD.masked_joints

    def masked_joints(self, feats, mask):
        out = orig(self, feats, mask).clone()
        out[0] *= 1.1
        return out
    monkeypatch.setattr(MLD, "masked_joints", masked_joints)


FAULTS = [noise_skipped, cfg_swapped, other_generator, unmasked_features,
          joints_scaled]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_makes_run_incorrect(home, fault, monkeypatch):
    fault(monkeypatch)
    res = run(home)
    assert not res["correct"], res["checks"]


def test_fault_in_one_row_pair_fails_the_row_count(tmp_path, monkeypatch):
    """At 24 motions a call, one motion's denoiser rows zeroed at every
    step: the count of rows over the bar fails."""
    forward = RawMotionDenoiser.forward

    def pair(self, sample, *args, **kwargs):
        out = forward(self, sample, *args, **kwargs).clone()
        out[0] = 0.0
        out[sample.shape[0] // 2] = 0.0
        return out
    monkeypatch.setattr(RawMotionDenoiser, "forward", pair)
    res = run(raw_home(tmp_path, batch=24))
    chk = res["checks"]
    assert not res["correct"]
    assert chk["loop_rows_over"]["value"] > chk["loop_rows_over"]["limit"]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_control_is_not_correct(home, seed):
    c = core.Cell(CELL, home=home)
    r = core.Run(c, seed, 0.0, False, "cpu")
    prog = mld_raw.build(c.conf, "cpu")
    shapes = {k: tuple(v.shape) for k, v in prog.state_dict().items()}
    w = wts.make(shapes, seed, "cpu")
    inputs = mld_raw.Inputs(c.conf, c.spec, seed, "cpu")
    recs = [(n, mld_raw.control(w, inputs.call(n), c.conf, r.env))
            for n in range(c.spec["pool"])]
    numbers = mld_raw.judge(w, recs, c.conf, c.spec, seed, "cpu", c.bars)
    assert numbers["chain_breaks"] == 0 and numbers["tokens_wrong"] == 0
    assert not core.correct_of(core.checks(numbers, c.limits), 0), numbers


def test_full_size_counts():
    """novae_humanml3d at B=32, bucket 24, every frame valid: about 645
    GFLOP a DDPM step (12,544 frame rows), 100 steps; K3 twice a layer and
    step, K4 24."""
    conf = load_json(HERE / "configs" / "novae_humanml3d.json")
    b = {"B": 32, "bucket": 24, "lengths": [196] * 32}
    env = {"MLD_TPU_MATMUL_PRECISION": "default"}
    d, ff, T, rows = 512, 1024, 196, 64 * 196
    per_row = 9 * (2 * (4 * d * d + 2 * d * d + 2 * d * ff)
                   + 4 * T * d + 4 * 2 * d) + 2 * 2 * 263 * d
    step = rows * per_row + 9 * 64 * 2 * 2 * 2 * d * d \
        + 2 * (768 * d + d * d)
    assert 640e9 < step < 650e9
    text = mld_raw.flops(conf, b) - 100 * step
    assert 0 < text < 0.01 * mld_raw.flops(conf, b)
    ls = mld_raw.launches(conf, b, env)
    assert len(ls["k4"]) == 24 and len(ls["raw_k3"]) == 1800
    self_, cross = ls["raw_k3"][:2]
    assert (self_["B"], self_["Sq"], self_["Sk"], self_["Dh"]) == (64, 196,
                                                                 196, 128)
    assert (cross["Sk"], cross["keys"], cross["arith"]) == (2, 128, "bf16")
    assert not self_["mask"] and self_["keys"] == 64 * 196


def test_denoise_idle_reads_as_idle_ms_and_in_time():
    """``raw_denoise_idle_ms`` gives ``ProgramTrace.idle_ms`` of the
    sublayer spans on a canned trace (gaps opening inside, across and
    outside them), None without them, and reads 6 calls of 22k device
    events and 37k spans each (a raw call has 44k and 11k) in seconds."""
    import time
    import types

    from benchmark.metrics import _program
    from benchmark.tests.test_program_trace import CPU, CUDA, raw

    reader = core.load_module("metrics", "raw_denoise_idle_ms")

    def trace_of(n_calls, steps):
        events, counts = [], {}
        for c in range(n_calls):
            t = c * (steps * 40 + 20)
            events.append(raw("bench.call", t, t + steps * 40 + 10, CPU))
            for k in range(steps):
                u = t + 5 + 40 * k
                events += [raw("mld.loop.denoise", u, u + 30, CPU),
                           raw("mld.attn.self", u + 1, u + 10, CPU),
                           raw("mld.cast.bf16", u + 2, u + 3, CPU),
                           raw("mld.attn.cross", u + 10, u + 20, CPU),
                           raw("mld.ffn", u + 20, u + 29, CPU),
                           raw("k", u + 4, u + 8, CUDA),
                           raw("k", u + 12, u + 22, CUDA),
                           raw("k", u + 31, u + 33, CUDA)]
        return types.SimpleNamespace(program_phase=_program.ProgramTrace(
            events, counts, CUDA))

    small = trace_of(2, 3)
    p = small.program_phase
    assert reader.read(small) == pytest.approx(p.idle_ms(reader.SPANS))
    assert reader.read(small) > 0
    p.program = [h for h in p.program if h[0] not in reader.SPANS]
    assert reader.read(small) is None
    big = trace_of(6, 7300)
    t0 = time.perf_counter()
    assert reader.read(big) > 0
    assert time.perf_counter() - t0 < 30


@pytest.mark.card
def test_graphed_loop_is_the_eager_loop(card, monkeypatch):
    """On the card the raw loop replays its denoiser call as a CUDA graph
    (``mld_tpu_torch/models/denoise_graph.py``): at the cell's widths and
    precision it gives bitwise the features and the counters of the eager
    loop (which runs while the trace spans are on), is captured once for
    calls of one shape and again for another."""
    from mld_tpu_torch.utils import trace
    monkeypatch.setenv("MLD_TPU_MATMUL_PRECISION", "default")
    conf = load_json(HERE / "configs" / "novae_humanml3d.json")
    mld = mld_raw.build(conf, card)
    texts = ["a person walks forward and waves.", "someone jumps",
             "a man kicks with his left leg then turns around.", "a spin"]
    mask = (torch.arange(196, device=card)[None]
            < torch.tensor([196, 40, 120, 77], device=card)[:, None])
    ids = mld.tokenize(texts)
    init = torch.randn((4, 196, 263), device=card,
                       generator=torch.Generator(card).manual_seed(11))

    def feats(graphed, n=4):
        trace.enable(not graphed)
        trace.COUNTS.clear()
        g = torch.Generator(card).manual_seed(2 ** 31 + 9)
        try:
            out = mld.generate_feats(ids[:n], mask[:n], generator=g,
                                     init_latents=init[:n])
        finally:
            trace.enable(False)
        torch.cuda.synchronize()
        return out, {k: v for k, v in trace.COUNTS.items() if v}

    eager, eager_counts = feats(False)
    assert mld._graph is None
    graphed, counts = feats(True)
    first = mld._graph
    assert first is not None and first.graph is not None
    assert torch.equal(graphed, eager)
    assert counts == eager_counts and counts["launch.k3.bf16"] > 0
    again, _ = feats(True)
    assert mld._graph is first and torch.equal(again, eager)
    half, _ = feats(True, 2)
    assert mld._graph is not first and torch.equal(half, feats(False, 2)[0])
