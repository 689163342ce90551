"""The bf16 linear kernel's dispatch and counters, on the CPU.

On the card every f32 reduced linear under the bf16 arithmetic
(``precision._ReducedLinear``) launches ``ops/linear_bf16.py``'s kernel; on
the CPU it still goes through ``precision._mm`` and the bias add, counts
the same cast bytes and launches nothing; "highest" never reaches the
kernel's wrapper. The wrapper refuses what the kernel does not take, and
its plain version (``precision.linear_plain``) is the CPU's reduced linear
bit for bit. The kernel
itself is held to that plain version on the card
(``benchmark/tests/test_linear_bf16.py``).
"""
import collections

import pytest
import torch

from mld_tpu_torch.ops.linear_bf16 import linear_bf16
from mld_tpu_torch.utils import precision, trace


def _operands(bias=True):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 7, 24, generator=g)
    w = torch.randn(10, 24, generator=g)
    b = torch.randn(10, generator=g) if bias else None
    return x, w, b


@pytest.mark.parametrize("setting", ["default", "high", "highest"])
@pytest.mark.parametrize("bias", [True, False])
def test_cpu_linear_goes_through_mm_and_counts_its_casts(monkeypatch,
                                                         setting, bias):
    seen = collections.Counter()
    mm = precision._mm

    def spy(a, b, mode):
        seen["cast.act_bytes." + mode] += a.numel() * 4
        seen["cast.weight_bytes." + mode] += b.numel() * 4
        return mm(a, b, mode)

    def kernel(*args):
        raise AssertionError("the kernel's wrapper was reached")

    monkeypatch.setattr(precision, "_mm", spy)
    monkeypatch.setattr(precision, "_linear_bf16", kernel)
    x, w, b = _operands(bias)
    before = collections.Counter(trace.COUNTS)
    with precision.matmul_precision(setting):
        y = precision.linear(x, w, b)
    counted = collections.Counter(trace.COUNTS) - before
    assert counted == seen
    assert trace.COUNTS["launch.lin.bf16"] == before["launch.lin.bf16"]
    if setting == "highest":
        assert not seen
        assert torch.equal(y, torch.nn.functional.linear(x, w, b))
    else:
        mode = precision.ARITHMETIC[setting]
        assert seen == {"cast.act_bytes." + mode: x.numel() * 4,
                        "cast.weight_bytes." + mode: w.numel() * 4}
        want = (precision.round_bits(x, mode)
                @ precision.round_bits(w, mode).t())
        torch.testing.assert_close(y, want if b is None else want + b,
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("bias", [True, False])
def test_plain_version_is_the_cpu_reduced_linear(bias):
    x, w, b = _operands(bias)
    with precision.matmul_precision("default"):
        want = precision.linear(x, w, b)
    x2 = x.reshape(-1, 24)
    got = precision.linear_plain(x2, w, b, "bf16").reshape(want.shape)
    assert torch.equal(got, want)
    rounded = (precision.round_bits(x2, "bf16")
               @ precision.round_bits(w, "bf16").t())
    assert torch.equal(got.reshape(rounded.shape),
                       rounded if b is None else rounded + b)


@pytest.mark.parametrize("case", ["f32", "double", "bf16_weights",
                                  "no_bias"])
def test_wrapper_refuses_cpu_operands(case):
    """The CPU never reaches the kernel: its wrapper raises on CPU
    operands whatever else they are (on the card each other check is held
    alone, ``benchmark/tests/test_linear_bf16.py``)."""
    x, w, b = _operands()
    x = x.reshape(-1, 24)
    args = {"f32": (x, w, b), "double": (x.double(), w, b),
            "bf16_weights": (x, w.bfloat16(), b),
            "no_bias": (x, w)}[case]
    before = trace.COUNTS["launch.lin.bf16"]
    with pytest.raises(ValueError, match="CUDA"):
        linear_bf16(*args)
    assert trace.COUNTS["launch.lin.bf16"] == before


def test_bench_script_runs_its_plain_versions_on_the_cpu(tmp_path):
    """``scripts/bench_linear_bf16.py`` on ``--device cpu``: the plain
    version alone, the kernel's times "not measured"; the card test's
    shapes are its SHAPES."""
    import json

    from mld_tpu_torch.scripts import _bench, bench_linear_bf16

    out = tmp_path / "report.json"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bench_linear_bf16.main(["--shapes", "raw memory", "--iters", "1",
                                "--device", "cpu", "--json", str(out)])
    finally:
        torch.set_num_threads(n)
    report = json.loads(out.read_text())
    assert report["device"] == "cpu" and _bench.finite(report)
    (row,) = report["rows"]
    assert (row["M"], row["K"], row["N"]) == (128, 512, 512)
    assert row["plain_ms"] > 0 and row["bound_by"] == "bytes"
    assert row["ms"] is None and row["device_ms"] is None
    assert row["bias"] and row["plain_device_ms"] is None
    labels = [r[0] for r in bench_linear_bf16.SHAPES]
    assert len(set(labels)) == len(labels)
