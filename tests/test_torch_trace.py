"""The port's trace module (``mld_tpu_torch/utils/trace.py``) on the CPU:
the spans of a serving call and their tree, that tracing changes no
number, and the cast counters of the reduced GEMMs against the GEMMs'
shapes. Small text and action presets, as the other ``test_torch_*``
files build them."""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mld_tpu_torch.config import load_config
from mld_tpu_torch.models.mld import MLD, lengths_to_mask
from mld_tpu_torch.utils import precision, trace

TEXT_SMALL = {"model": {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
                        "denoiser_num_layers": 3, "num_heads": 4,
                        "text_encoded_dim": 48, "clip_layers": 2,
                        "clip_heads": 2, "clip_compute_dtype": "float32",
                        "scheduler": {"num_inference_timesteps": 4}},
              "dataset": {"max_motion_len": 24}}
ACTION_SMALL = {"model": {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
                          "denoiser_num_layers": 3, "num_heads": 4,
                          "scheduler": {"num_inference_timesteps": 3}}}
RAW_SMALL = {"model": {"latent_dim": 32, "ff_size": 64,
                       "denoiser_num_layers": 2, "num_heads": 2,
                       "text_encoded_dim": 48, "clip_layers": 2,
                       "clip_heads": 2, "clip_compute_dtype": "float32",
                       "scheduler": {"num_train_timesteps": 3}},
             "dataset": {"max_motion_len": 12}}
TEXTS = ["a man kicks something with his left leg.", "someone jumps"]
TEXT_LENGTHS = [24, 13]
ACTION_LENGTHS = [60, 31]
RAW_LENGTHS = [12, 7]
# where each span sits: its nearest mld.* ancestor (None: a root); a
# decoder layer's sublayers sit in the decode, or in the raw-motion
# denoiser's call
PARENT = {"tokenize": None, "generate": None,
          "condition": "generate", "condition.uncond": "condition",
          "condition.tower": "condition", "loop": "generate",
          "loop.preamble": "loop", "loop.step": "loop",
          "loop.denoise": "loop.step", "loop.cfg": "loop.step",
          "loop.scheduler": "loop.step", "loop.noise": "loop.scheduler",
          "decode": "generate", "joints": "generate"}
SUBLAYERS = ("attn.self", "attn.cross", "ffn")


@pytest.fixture(autouse=True)
def _tracing_off():
    trace.enable(False)
    yield
    trace.enable(False)


@pytest.fixture(scope="module")
def text_mld():
    torch.manual_seed(0)
    return MLD(load_config(preset="mld_humanml3d", overrides=TEXT_SMALL),
               device="cpu", fused_denoiser=True)


@pytest.fixture(scope="module")
def action_mld():
    return MLD(load_config(preset="mld_humanact12", overrides=ACTION_SMALL),
               device="cpu", fused_denoiser=True)


@pytest.fixture(scope="module")
def raw_mld():
    return MLD(load_config(preset="novae_humanml3d", overrides=RAW_SMALL),
               device="cpu")


def _text_call(mld):
    mask = lengths_to_mask(TEXT_LENGTHS, mld.max_frames, "cpu")
    init = torch.randn((len(TEXTS), mld.latent_size, mld.latent_dim),
                       generator=torch.Generator().manual_seed(3))
    return lambda: mld.generate_joints(mld.tokenize(TEXTS), mask,
                                       init_latents=init)


def _action_call(mld):
    T = mld.cfg.dataset.num_frames
    mask = lengths_to_mask(ACTION_LENGTHS, T, "cpu")
    init = torch.randn((2, mld.latent_size, mld.latent_dim),
                       generator=torch.Generator().manual_seed(4))
    return lambda: mld.generate_joints(torch.tensor([3, 7]), mask,
                                       init_latents=init)


def _raw_call(mld):
    mask = lengths_to_mask(RAW_LENGTHS, mld.max_frames, "cpu")
    init = torch.randn((len(TEXTS), mld.max_frames, mld.nfeats),
                       generator=torch.Generator().manual_seed(5))
    return lambda: mld.generate_joints(
        mld.tokenize(TEXTS), mask, init_latents=init,
        generator=torch.Generator().manual_seed(6))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("mld.")]


def _mld_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("mld."):
        p = p.cpu_parent
    return p


def test_spans_off_record_nothing_and_allocate_nothing(text_mld, raw_mld):
    assert not trace.enabled()
    assert trace.span("loop") is trace.span("decode")
    for name in SUBLAYERS + ("loop.noise",):
        assert trace.span(name) is trace._OFF
    assert isinstance(trace.span("loop"), type(trace._OFF))
    for fn in (_text_call(text_mld), _raw_call(raw_mld)):
        _, spans = _profiled(fn)
        assert spans == []


@pytest.mark.parametrize("kind", ["text", "action"])
def test_span_tree(text_mld, action_mld, kind):
    mld = text_mld if kind == "text" else action_mld
    fn = _text_call(mld) if kind == "text" else _action_call(mld)
    trace.enable(True)
    with precision.matmul_precision("default"):
        _, spans = _profiled(fn)
    trace.enable(False)
    names = collections.Counter(e.name[len("mld."):] for e in spans)
    steps = len(mld.scheduler.timesteps())
    want = {"generate": 1, "condition": 1, "loop": 1, "loop.preamble": 1,
            "loop.step": steps, "loop.denoise": steps, "loop.cfg": steps,
            "loop.scheduler": steps, "decode": 1, "joints": 1}
    # the plain VAE decoder's and the ACTOR decoder's layers
    want.update(dict.fromkeys(SUBLAYERS, mld.cfg.model.num_layers))
    if kind == "text":
        want.update({"tokenize": 1, "condition.uncond": 1,
                     "condition.tower": 1})
    casts = {n: c for n, c in names.items() if n.startswith("cast.")}
    assert set(casts) == {"cast.bf16"}       # default: bf16 operands
    assert {n: c for n, c in names.items() if n not in casts} == want
    for e in spans:
        name = e.name[len("mld."):]
        parent = _mld_parent(e)
        if name.startswith("cast."):
            assert parent is not None and parent.name != "mld.generate"
            continue
        want_parent = "decode" if name in SUBLAYERS else PARENT[name]
        assert (parent.name[len("mld."):] if parent else None) \
            == want_parent, name
    for step in (e for e in spans if e.name == "mld.loop.step"):
        kids = collections.Counter(
            e.name for e in spans if _mld_parent(e) is step)
        assert kids == {"mld.loop.denoise": 1, "mld.loop.cfg": 1,
                        "mld.loop.scheduler": 1}
        assert all(c.time_range.start >= step.time_range.start
                   and c.time_range.end <= step.time_range.end
                   for c in spans if _mld_parent(c) is step)


def test_raw_motion_span_tree_and_noise_bytes(raw_mld):
    """The raw-motion call's spans: a decoder layer's sublayers inside each
    denoiser call, the ancestral draw inside each scheduler update; and
    B * T * 263 * 4 noise bytes a step, counted with the spans off too."""
    mld = raw_mld
    steps = len(mld.scheduler.timesteps())
    layers = mld.cfg.model.denoiser_num_layers
    before = trace.COUNTS["noise.bytes"]
    trace.enable(True)
    with precision.matmul_precision("default"):
        _, spans = _profiled(_raw_call(mld))
    trace.enable(False)
    step_bytes = len(TEXTS) * mld.max_frames * mld.nfeats * 4
    assert trace.COUNTS["noise.bytes"] - before == steps * step_bytes
    names = collections.Counter(e.name[len("mld."):] for e in spans)
    want = {"tokenize": 1, "generate": 1, "condition": 1,
            "condition.uncond": 1, "condition.tower": 1, "loop": 1,
            "loop.step": steps, "loop.denoise": steps, "loop.cfg": steps,
            "loop.scheduler": steps, "loop.noise": steps, "joints": 1}
    want.update(dict.fromkeys(SUBLAYERS, steps * layers))
    assert {n: c for n, c in names.items()
            if not n.startswith("cast.")} == want
    for e in spans:
        name = e.name[len("mld."):]
        if name.startswith("cast."):
            continue
        parent = _mld_parent(e)
        want_parent = "loop.denoise" if name in SUBLAYERS else PARENT[name]
        assert (parent.name[len("mld."):] if parent else None) \
            == want_parent, name
        if parent is not None:
            assert parent.time_range.start <= e.time_range.start
            assert e.time_range.end <= parent.time_range.end
    before = trace.COUNTS["noise.bytes"]
    with precision.matmul_precision("default"):
        _raw_call(mld)()
    assert trace.COUNTS["noise.bytes"] - before == steps * step_bytes


@pytest.mark.parametrize("kind", ["text", "action", "raw"])
def test_tracing_changes_no_number(text_mld, action_mld, raw_mld, kind):
    mld, fn = {"text": (text_mld, _text_call), "action": (action_mld,
                                                          _action_call),
               "raw": (raw_mld, _raw_call)}[kind]
    fn = fn(mld)
    with precision.matmul_precision("default"):
        off = fn()
        trace.enable(True)
        with profile(activities=[ProfilerActivity.CPU]):
            on = fn()
        trace.enable(False)
    assert torch.equal(off, on)


@pytest.mark.parametrize("setting", ["default", "high", "highest"])
def test_cast_bytes_equal_the_reduced_gemms_shapes(text_mld, monkeypatch,
                                                   setting):
    """Every GEMM the reduced linears ran, seen at ``precision._mm``, gives
    its activation bytes (M x K) and weight bytes (K x N) in f32; the
    counters must add up to them, by arithmetic."""
    seen = collections.Counter()
    mm = precision._mm

    def spy(a, b, mode):
        seen["cast.act_bytes." + mode] += a.numel() * 4
        seen["cast.weight_bytes." + mode] += b.numel() * 4
        return mm(a, b, mode)

    monkeypatch.setattr(precision, "_mm", spy)
    before = collections.Counter(
        {k: v for k, v in trace.COUNTS.items() if k.startswith("cast.")})
    with precision.matmul_precision(setting), torch.no_grad():
        _text_call(text_mld)()
    after = collections.Counter(
        {k: v for k, v in trace.COUNTS.items() if k.startswith("cast.")})
    counted = after - before
    assert counted == seen
    if setting == "highest":
        assert not counted and trace.total("cast") == sum(before.values())
    else:
        arith = precision.ARITHMETIC[setting]
        assert set(counted) == {"cast.act_bytes." + arith,
                                "cast.weight_bytes." + arith}
        # the tower's weights alone: 2 layers x (q, k, v, out, fc1, fc2)
        # over the empty prompt and again over the prompts, D = 48
        tower = 2 * 2 * (4 * 48 * 48 + 2 * 48 * 4 * 48) * 4
        assert counted["cast.weight_bytes." + arith] > tower


def test_total_sums_a_family_by_dotted_prefix(monkeypatch):
    counts = collections.Counter({"launch.k3.f32": 2, "launch.k3.bf16": 5,
                                  "launch.k3.bf16 tensors": 1,
                                  "launch.k1.bf16": 7, "launch.k10": 100})
    monkeypatch.setattr(trace, "COUNTS", counts)
    assert trace.total("launch.k3") == 8
    assert trace.total("launch.k3.bf16") == 5
    assert trace.total("launch.k1") == 7
    assert trace.total("launch") == 115
    assert trace.total("flops") == 0


def test_launch_counters_count_nothing_on_the_cpu(action_mld):
    before = {k: v for k, v in trace.COUNTS.items()
              if k.startswith(("launch.", "kernels.", "flops."))}
    _action_call(action_mld)()
    after = {k: v for k, v in trace.COUNTS.items()
             if k.startswith(("launch.", "kernels.", "flops."))}
    assert after == before
    assert np.isfinite(_action_call(action_mld)().numpy()).all()


def test_profile_serving_span_table_self_and_idle_time(tmp_path):
    """``scripts/profile_serving.py:span_table`` on a written Chrome trace:
    self time less the child spans, idle by the innermost open span."""
    import json

    from mld_tpu_torch.scripts import profile_serving

    def x(name, ts, dur, cat, tid=1):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
                "pid": 1, "tid": tid}
    events = [x("mld.generate", 0, 100, "user_annotation"),
              x("mld.loop", 10, 60, "user_annotation"),
              x("mld.loop.step", 12, 20, "user_annotation"),
              x("mld.loop.step", 40, 20, "user_annotation"),
              x("aten::mm", 13, 5, "cpu_op"),
              x("k", 0, 15, "kernel", tid=7), x("k", 30, 20, "kernel", tid=7),
              x("copy", 80, 10, "gpu_memcpy", tid=7)]
    (tmp_path / "t.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    rows = {name: (n, us, idle) for name, n, us, idle
            in profile_serving.span_table(str(tmp_path))}
    assert rows["generate"] == (1, 40.0, 10.0)   # idle [90, 100]
    assert rows["loop"] == (1, 20.0, 0.0)
    assert rows["loop.step"] == (2, 40.0, 45.0)  # idle [15, 30], [50, 80]
    assert list(rows) == ["generate", "loop", "loop.step"]
    # the device's times 10 us early, as a launch shows (the kernel read at
    # 20 was issued at 30): idle moves back with them
    early = [dict(e, ts=e["ts"] - 10) if e["cat"] in ("kernel", "gpu_memcpy")
             else e for e in events]
    early[6]["args"] = {"correlation": 9}
    launch = dict(x("cudaLaunchKernel", 30, 2, "cuda_runtime"),
                  args={"correlation": 9})
    (tmp_path / "t.trace.json").write_text(
        json.dumps({"traceEvents": early + [launch]}))
    assert {name: (n, us, idle) for name, n, us, idle
            in profile_serving.span_table(str(tmp_path))} == rows
    (tmp_path / "t.trace.json").write_text(json.dumps(
        {"traceEvents": [e for e in events if e["cat"] != "kernel"
                         and e["cat"] != "gpu_memcpy"]}))
    assert all(idle is None for *_, idle
               in profile_serving.span_table(str(tmp_path)))


def test_profile_serving_turns_the_spans_on(tmp_path, monkeypatch):
    from mld_tpu_torch.scripts import profile_serving

    monkeypatch.delenv(precision.SESSION_VAR, raising=False)
    summary, _ = profile_serving.main(
        ["--stage", "decode", "--batch", "2", "--iters", "1", "--device",
         "cpu", "--keep", str(tmp_path)])
    spans = {s["span"]: s for s in summary["spans"]}
    assert spans["decode"]["count"] == 1
    assert spans["cast.bf16"]["count"] > 0            # "default": bf16
    assert all(s["device_idle_us"] is None for s in spans.values())
    assert not trace.enabled()
