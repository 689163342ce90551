"""The port's five bench twins (``mld_tpu_torch/scripts/bench_*.py``) on
the CPU at tiny sizes: each runs end to end on ``--device cpu``, writes its
``--json`` report with the keys it shares with its JAX script (listed
here, read from ``scripts/bench_*.py``), finite, and takes none of the
JAX script's TPU-only flags. Without ``--device cpu`` and without a card a
twin raises rather than fall back to the CPU, and none imports JAX or the
JAX package. Their kernels and times on
the card are ``chip_smoke.py``'s (its bench phase).
"""
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

from mld_tpu_torch.scripts import (_bench, bench_attention, bench_decode,
                                   bench_fused_layer, bench_stages,
                                   bench_train)

HEADER = ("backend", "device", "nvidia_smi", "torch", "cuda")
TINY = """model:
  latent_dim: 64
  ff_size: 128
  num_layers: 3
  denoiser_num_layers: 3
  num_heads: 4
  text_encoded_dim: 48
  clip_layers: 2
  clip_heads: 2
  scheduler: {num_inference_timesteps: 3}
"""



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run's workers share the host's
    cores, and torch's default of one thread a core oversubscribes them
    (the decode twin took minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _run(module, argv, tmp_path):
    out = tmp_path / "report.json"
    module.main([*argv, "--device", "cpu", "--json", str(out)])
    with open(out) as f:
        report = json.load(f)
    assert _bench.finite(report)
    assert report["backend"] == "cpu" and report["device"] == "cpu"
    for key in HEADER:
        assert key in report
    return report


def _tiny_cfg(tmp_path, extra=""):
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY + extra)
    return str(path)


def _keys(d, keys):
    missing = [k for k in keys if k not in d]
    assert not missing, missing


def test_bench_stages(tmp_path, monkeypatch):
    monkeypatch.delenv("MLD_TPU_MATMUL_PRECISION", raising=False)
    cfg = _tiny_cfg(tmp_path, "dataset: {max_motion_len: 40}\n")
    r = _run(bench_stages, ["--batch", "2", "--iters", "1", "--cfg", cfg],
             tmp_path)
    _keys(r, ("batch", "precision", "stage_precision", "fused_denoiser",
              "fused_decode", "stages_ms", "stage_share", "stage_sum_ms",
              "total_ms", "fusion_gain_ms", "motions_per_sec_total",
              "per_scan_step_us"))
    _keys(r["stages_ms"], ("clip", "ddim50_scan", "vae_decode",
                           "feats2joints"))
    # the JAX script's serving default, for the run only
    assert r["precision"] == "default"
    assert all(v is None for v in r["stages_device_ms"].values())
    assert "MLD_TPU_MATMUL_PRECISION" not in os.environ


@pytest.mark.parametrize("dtype,arms", [
    ("float32", ["f32", "tf32", "bf16"]), ("bfloat16", ["bf16 tensors"])])
def test_bench_attention(tmp_path, dtype, arms):
    r = _run(bench_attention, ["--shapes", "denoiser_latent", "vae_decode",
                               "--batch", "1", "--iters", "1", "--dtype",
                               dtype], tmp_path)
    _keys(r, ("dtype", "iters", "rows"))
    assert [row["arm"] for row in r["rows"]] == arms * 2
    for row in r["rows"]:
        _keys(row, ("shape", "B", "H", "Sq", "Sk", "Dh", "xla_us",
                    "pallas_us", "speedup", "xla_tflops", "sdpa_us",
                    "bound_us", "bound_share", "max_abs_err"))
        assert row["device_us"] is None      # not measured on the CPU


def test_bench_fused_layer(tmp_path):
    r = _run(bench_fused_layer, ["--batches", "2", "--iters", "1"], tmp_path)
    assert [row["weight_dtype"] for row in r["rows"]] == ["f32", "bf16"]
    for row in r["rows"]:
        _keys(row, ("B", "S", "D", "L", "xla_us", "fused_us", "speedup",
                    "max_abs_err", "xla_stack_us", "fused_stack_us",
                    "stack_speedup", "stack_max_abs_err", "torch_layer_us"))
        assert row["plain_err"] == 0.0       # the plain version on the CPU


def test_bench_decode(tmp_path):
    r = _run(bench_decode, ["--batches", "2", "--iters", "1"], tmp_path)
    assert [row["weight_dtype"] for row in r["rows"]] == ["f32", "bf16"]
    for row in r["rows"]:
        _keys(row, ("B", "T", "D", "L", "weight_dtype", "xla_us", "fused",
                    "best"))
        _keys(row["best"], ("us", "speedup", "max_abs_err", "rel_err"))
    r = _run(bench_decode, ["--batches", "1", "--iters", "1", "--f32"],
             tmp_path)
    assert [row["weight_dtype"] for row in r["rows"]] == ["f32"]


def test_bench_train(tmp_path):
    cfg = _tiny_cfg(tmp_path, "dataset: {max_motion_len: 40}\n")
    r = _run(bench_train, ["--stage", "vae", "diffusion", "--batch", "4",
                           "--iters", "1", "--bf16",
                           "--remat", "--dropout", "0.1", "--cfg", cfg],
             tmp_path)
    assert [a["metric"] for a in r["stages"]] == [
        "vae_train_step_throughput", "diffusion_train_step_throughput"]
    for arm in r["stages"]:
        _keys(arm, ("metric", "value", "unit", "batch_size", "vs_baseline"))
        assert arm["gflops_per_step"] > 0
        assert arm["vs_baseline"] == pytest.approx(
            arm["value"] * 4 / (bench_train.REF_STEPS_PER_SEC * 64))


def test_bench_train_pipeline(tmp_path):
    r = _run(bench_train, ["--pipeline", "--no-prefetch", "--clips", "40",
                           "--data-root", str(tmp_path / "data"),
                           "--batch", "4", "--iters", "2",
                           "--cfg", _tiny_cfg(tmp_path)], tmp_path)
    arm, = r["stages"]
    _keys(arm, ("metric", "value", "unit", "batch_size", "vs_baseline",
                "prefetch", "native_collate"))
    assert arm["metric"] == "diffusion_train_pipeline_throughput"
    assert arm["prefetch"] == 0


@pytest.mark.parametrize("module,flag", [
    (bench_stages, ["--chain", "10"]),
    (bench_fused_layer, ["--chain", "50"]),
    (bench_decode, ["--tiles", "4"]),
    (bench_decode, ["--ffn-chunks", "2"]),
    (bench_train, ["--spd", "8"]),
    (bench_train, ["--device-data"]),
    (bench_train, ["--fixed-scan"]),
    (bench_train, ["--ab"]),
])
def test_tpu_only_flags_are_left_out(module, flag):
    with pytest.raises(SystemExit):
        module.parse_args(flag)


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        bench_attention.main(["--shapes", "denoiser_latent", "--batch", "1",
                              "--iters", "1"])


def test_the_twins_import_no_jax():
    code = ("import json, sys\n"
            "from mld_tpu_torch.scripts import (bench_attention, bench_decode,"
            " bench_fused_layer, bench_stages, bench_train)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mld_tpu.')) or m == 'mld_tpu')))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module,source", [
    ("bench_flash_reduced_parts", "flash_attention.cu"),
    ("bench_skip_encoder_parts", "skip_encoder.cu")])
def test_parts_study_variants_match_the_source(module, source):
    # each variant of a parts study edits lines of the kernel's source that
    # must be there as many times as it says (the study builds them on the
    # card only; a change of the kernel fails here first)
    mod = importlib.import_module(f"mld_tpu_torch.scripts.{module}")
    whole = _bench.edit_source(source, "whole", ())
    for name, edits in mod.VARIANTS.items():
        assert (_bench.edit_source(source, name, edits) != whole) == bool(edits)

