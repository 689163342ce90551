"""The per-layer readers on a small canned profiler trace."""
import types

import pytest
import torch

from benchmark import core
from benchmark.kernels import k1, peaks

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
K1_NAME = ("void (anonymous namespace)::skip_encoder_kernel<__nv_bfloat16>"
           "((anonymous namespace)::Args<__nv_bfloat16>)")
LAUNCH = dict(n_seq=256, s=3, d=256, f=1024, n_block=4, wbytes=2,
              arith="bf16")


def ev(name, start, end, dev):
    return types.SimpleNamespace(
        name=name, device_type=dev,
        time_range=types.SimpleNamespace(start=start, end=end))


def canned():
    """Two calls, [0, 100] and [120, 220] us; K1 30 us in each, a GEMM in
    the first, a copy at the end of each; the host's stage ranges, and
    the scan's annotation on the device's timeline (not device work)."""
    events = [
        ev("bench.call", 0, 100, CPU), ev("bench.call", 120, 220, CPU),
        ev("bench.scan", 5, 70, CPU), ev("bench.scan", 125, 180, CPU),
        ev("bench.copy", 85, 100, CPU), ev("bench.copy", 205, 220, CPU),
        ev("bench.scan", 5, 70, CUDA),
        ev(K1_NAME, 10, 40, CUDA), ev(K1_NAME, 130, 160, CUDA),
        ev("nvjet_tst_192x128_64x5_1x2_h_bz_coopB_bias_TNT", 40, 60, CUDA),
        ev("Memcpy DtoH (Device -> Pageable)", 90, 95, CUDA),
        ev("Memcpy DtoH (Device -> Pageable)", 210, 215, CUDA),
        ev("aten::mm", 12, 20, CPU),
    ]
    family = types.SimpleNamespace(
        launches=lambda conf, b, env: {"k1": [LAUNCH]},
        flops=lambda conf, b: 1e9)
    cell = types.SimpleNamespace(family=family, conf={})
    run = types.SimpleNamespace(cell=cell, env={}, torch=torch)
    a = {"seconds": 0.5, "batches": [{}, {}]}
    t = {"spans": [{"tokenize": 0.001, "text": 0.004, "scan": 0.010,
                    "decode": 0.003, "joints": 0.0005, "copy": 0.0015},
                   {"tokenize": 0.003, "text": 0.002, "scan": 0.012,
                    "decode": 0.005, "joints": 0.0015, "copy": 0.0005}],
         "a": a, "prof": {"batches": [{}, {}]}, "events": events}
    tr = core.Trace(run, t)
    tr.flops = 2e9
    return tr


def read(name, tr):
    return core.load_module("metrics", name).read(tr)


def test_window_busy_and_idle():
    tr = canned()
    assert tr.window_s == pytest.approx(220e-6)
    assert tr.busy_s == pytest.approx((30 + 20 + 5 + 30 + 5) * 1e-6)
    assert read("idle_share", tr) == pytest.approx(100 * 130 / 220)
    assert read("launches_per_call", tr) == 2.5


def test_times_by_kernel_name_and_roofline():
    tr = canned()
    assert tr.device_seconds(k1.PATTERNS) == pytest.approx(60e-6)
    least = 2 * peaks.least_seconds(*k1.work(LAUNCH), "bf16")
    assert read("k1_roofline", tr) == pytest.approx(100 * least / 60e-6)
    assert read("k3_roofline", tr) is None      # launched nowhere
    ops = dict(tr.breakdown()["device_ops"])
    assert ops[K1_NAME] == pytest.approx(60e-6)
    assert "bench.scan" not in ops


def test_idle_gaps_labelled_by_host_span():
    gaps = canned().gaps()
    assert ("call", pytest.approx(10e-6)) in gaps            # [0, 10]
    assert ("scan", pytest.approx(30e-6)) in gaps            # [60, 90]
    assert ("copy", pytest.approx(35e-6)) in gaps            # [95, 130]
    assert sum(g for _, g in gaps) == pytest.approx(130e-6)


def test_stage_spans_and_mfu():
    tr = canned()
    assert read("text_ms", tr) == pytest.approx(5.0)
    assert read("scan_ms", tr) == pytest.approx(11.0)
    assert read("decode_ms", tr) == pytest.approx(4.0)
    assert read("joints_ms", tr) == pytest.approx(2.0)
    assert read("mfu", tr) == pytest.approx(100 * 2e9 / 0.5 / 989e12)
    no_text = canned()
    for c in no_text.spans:
        del c["tokenize"]
    assert read("text_ms", no_text) is None
