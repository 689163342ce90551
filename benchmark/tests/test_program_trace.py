"""The readers of the program's own spans and counters
(``metrics/_program.py``): on a canned trace, in a tiny traced run on the
CPU, against a program without the trace module, and (marked ``card``) on
the card, where the spans and the device's kernels share one clock."""
import sys
import types

import pytest
import torch

from benchmark import core
from benchmark.metrics import _program
from benchmark.tests import tiny

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
NEW = ("tokenize_ms", "step_host_us", "text_idle_ms", "loop_idle_ms",
       "decode_idle_ms", "joints_idle_ms", "cast_mb")
STAGE_IDLE = ("text_idle_ms", "loop_idle_ms", "decode_idle_ms",
              "joints_idle_ms")


def raw(name, start_us, end_us, dev, corr=0):
    """A raw profiler event as ``kineto_results.events()`` gives it."""
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: dev,
        start_ns=lambda: int(start_us * 1000),
        end_ns=lambda: int(end_us * 1000),
        correlation_id=lambda: corr)


ev = raw


def one_call(t):
    """A call at t us: the host's spans and the device's events (us)."""
    host = [("bench.call", 0, 100), ("mld.tokenize", 1, 6),
            ("mld.generate", 8, 95), ("mld.condition", 8, 30),
            ("mld.condition.uncond", 9, 15), ("mld.condition.tower", 16, 29),
            ("mld.cast.bf16", 17, 18), ("mld.loop", 31, 70),
            ("mld.loop.step", 33, 50), ("mld.loop.denoise", 34, 40),
            ("mld.loop.step", 51, 68), ("mld.loop.denoise", 52, 58),
            ("mld.decode", 72, 85), ("mld.joints", 86, 93)]
    dev = [("uncond_kernel", 12, 20), ("tower_kernel", 25, 32),
           ("skip_encoder_kernel", 40, 55), ("skip_encoder_kernel", 60, 70),
           ("decode_kernel", 71, 75), ("decode_kernel", 80, 88),
           ("Memcpy DtoH (Device -> Pageable)", 90, 97)]
    out = [ev(n, t + s, t + e, CPU) for n, s, e in host]
    out += [ev(n, t + s, t + e, CUDA) for n, s, e in dev]
    # the annotations' copies on the device's lane are not device work
    out += [ev("mld.loop", t + 31, t + 70, CUDA),
            ev("bench.call", t, t + 100, CUDA)]
    return out


def canned():
    events = one_call(0) + one_call(120) + [ev("aten::mm", 41, 43, CPU)]
    counts = {"cast.act_bytes.bf16": 3_000_000,
              "cast.weight_bytes.bf16": 1_000_000, "launch.k1.bf16": 100}
    return types.SimpleNamespace(
        program_phase=_program.ProgramTrace(events, counts, CUDA))


def read(name, tr):
    return core.load_module("metrics", name).read(tr)


def union_us(iv):
    total, end, start = 0.0, None, None
    for s, e in sorted(iv):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total + (end - start if end is not None else 0.0)


def test_stage_idle_and_the_rest_sum_to_the_idle_time():
    tr = canned()
    p = tr.program_phase
    assert p.program_calls == 2 and (p.t0, p.t1) == (0, 220)
    assert len(p.program_events) == 14                # no annotation
    idle_s = ((p.t1 - p.t0) - union_us(
        [(s, e) for _, s, e in p.program_events])) / 1e6
    gaps = p.program_gaps()
    assert sum(g for _, _, g in gaps) == pytest.approx(idle_s, abs=1e-12)
    labels = {round(s): label for label, s, _ in gaps}
    assert labels[0] == "outside" and labels[97] == "outside"
    assert labels[20] == "condition.tower" and labels[32] == "loop"
    assert labels[55] == "loop.denoise" and labels[70] == "generate"
    assert labels[75] == "decode" and labels[88] == "joints"
    stages = sum(read(m, tr) for m in STAGE_IDLE) * p.program_calls / 1e3
    rest = sum(g for label, _, g in gaps
               if label in ("outside", "generate"))
    assert abs(stages + rest - idle_s) <= 1e-9
    assert read("text_idle_ms", tr) == pytest.approx(5e-3)    # [20, 25]
    assert read("loop_idle_ms", tr) == pytest.approx(13e-3)   # + [55, 60]
    assert read("decode_idle_ms", tr) == pytest.approx(5e-3)  # [75, 80]
    assert read("joints_idle_ms", tr) == pytest.approx(2e-3)  # [88, 90]


def test_host_spans_and_counters():
    tr = canned()
    assert read("tokenize_ms", tr) == pytest.approx(5e-3)
    assert read("step_host_us", tr) == pytest.approx(17.0)
    assert read("cast_mb", tr) == pytest.approx(2.0)
    assert tr.program_phase.total("launch.k1") == 100


def test_without_a_device_lane_the_idle_readers_give_none():
    events = [e for e in one_call(0) + one_call(120)
              if e.device_type() == CPU]
    tr = types.SimpleNamespace(
        program_phase=_program.ProgramTrace(events, {}, CUDA))
    assert all(read(m, tr) is None for m in STAGE_IDLE)
    assert read("tokenize_ms", tr) == pytest.approx(5e-3)
    assert read("cast_mb", tr) == 0.0


def test_device_times_are_put_on_the_hosts_clock_call_by_call():
    """Each call's device events move by the largest lead of an event over
    the runtime call that issued it; a call where none leads stays."""
    events = one_call(0) + one_call(120)
    # call 1: a kernel issued at 24 us but read at 20 (4 us early)
    events += [raw("cudaLaunchKernel", 24, 25, CPU, 52),
               raw("k_early", 20, 21, CUDA, 52),
               # call 2: an event that starts after its launch: no shift
               raw("cudaLaunchKernel", 150, 151, CPU, 53),
               raw("k_late", 160, 161, CUDA, 53)]
    p = _program.ProgramTrace(events, {}, CUDA)
    assert p.clock_shift_us == [4.0, 0.0]
    assert ("k_early", 24, 25) in p.program_events
    assert ("uncond_kernel", 16, 24) in p.program_events    # moved with it
    assert ("k_late", 160, 161) in p.program_events
    assert ("uncond_kernel", 132, 140) in p.program_events  # call 2: stays
    assert ("tokenize", 1, 6) in p.program                  # the host's


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    return tiny.make_home(tmp_path_factory.mktemp("bench"))


def test_tiny_traced_run_reads_the_program(home, capsys):
    res = core.execute("t2m_b128", 2 ** 31 + 17, 0.2, True, "cpu",
                       env=tiny.CPU_ENV, home=home)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    with capsys.disabled():
        print("\ntiny t2m_b128 on the CPU:",
              {k: m[k] for k in ("tokenize_ms", "step_host_us", "cast_mb")})
    assert m["tokenize_ms"] > 0 and m["step_host_us"] > 0
    assert m["cast_mb"] > 0                       # default: bf16 operands
    assert not set(STAGE_IDLE) & set(m)           # no device lane
    # every earlier metric is still read, and tracing is off again
    assert {"text_ms", "scan_ms", "decode_ms", "joints_ms"} <= set(m)
    from mld_tpu_torch.utils import trace
    assert not trace.enabled()
    action = core.execute("a2m_b128", 5, 0.2, True, "cpu",
                          env=tiny.CPU_ENV, home=home)
    assert action["correct"]
    assert "step_host_us" in action["metrics"]
    assert "tokenize_ms" not in action["metrics"]


def test_a_program_without_the_trace_module_gives_no_reading(home,
                                                             monkeypatch):
    """As the parent commit of the trace module: the new metrics are
    left out and nothing raises."""
    import mld_tpu_torch.models.mld  # noqa: F401  (the program, loaded)
    import mld_tpu_torch.utils
    monkeypatch.delattr(mld_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "mld_tpu_torch.utils.trace", None)
    res = core.execute("a2m_b128", 6, 0.2, True, "cpu", env=tiny.CPU_ENV,
                       home=home)
    assert res["correct"]
    assert not set(NEW) & set(res["metrics"])
    assert "scan_ms" in res["metrics"]


@pytest.mark.card
def test_spans_and_kernels_share_the_clock(card):
    """t2m_b128 on the card, a short window: K1 launches 50 a call by the
    counters and by the device's events, each kernel, on the host's clock,
    after the start of the ``mld.loop.denoise`` span that launched it."""
    cell = core.Cell("t2m_b128")
    run = core.Run(cell, 2 ** 31 + 29, 2.0, True)
    run.setup()
    t = run.traced()
    tr = core.Trace(run, t)
    p = _program.phase(tr)
    assert p is not None and p.program_calls == core.TRACED_CALLS
    print(f"\nthe device's clock moved by {p.clock_shift_us} us a call")
    assert len(p.clock_shift_us) == p.program_calls
    k1 = sorted((s for n, s, _ in p.program_events
                 if "skip_encoder_kernel" in n))
    assert p.total("launch.k1") == 50 * p.program_calls == len(k1)
    denoise = sorted(s for n, s, _ in p.program if n == "loop.denoise")
    assert len(denoise) == len(k1)
    assert all(d <= k for d, k in zip(denoise, k1))
    assert p.idle_ms(_program.LOOP) is not None
