"""Tiny cells for the CPU tests: the two configurations cut to a few
layers and narrow widths, a short schedule and small batches, written as a
benchmark folder of data beside a BENCHMARK.json of their own. The
harness's code is the real one; only these files differ."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CPU_ENV = {"MLD_TPU_FUSED_DENOISER": "1"}   # K1's plain version on the CPU

SHRINK = {"text_encoded_dim": 64, "clip_layers": 2, "clip_heads": 2,
          "latent_dim": 32, "ff_size": 64, "num_heads": 2, "num_layers": 3,
          "denoiser_num_layers": 3}


def tiny_conf(name: str) -> dict:
    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    conf["model"].update(SHRINK)
    conf["model"]["scheduler"]["num_inference_timesteps"] = 4
    if conf["model"]["condition"] == "text":
        conf["dataset"]["max_motion_len"] = 16
    else:
        conf["dataset"]["num_frames"] = 12
    return conf


def tiny_traffic(name: str, batch: int = 4) -> dict:
    spec = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    spec.update(batch=batch, pool=2)
    if spec["kind"] == "text":
        spec["words"] = {"min": 3, "max": 12, "median": 5, "sigma": 0.6}
        spec["frames"] = {"min": 6, "max": 16}
    else:
        spec["frames"] = 12
    return spec


def make_home(tmp: Path, cells=("t2m_b128", "a2m_b128"),
              limits: dict = None, batch: int = 4) -> Path:
    """A folder `tmp`/benchmark with tiny versions of `cells` (same names)
    and `tmp`/BENCHMARK.json naming them; returns the folder."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    home = tmp / "benchmark"
    for d in ("configs", "traffic", "workloads"):
        (home / d).mkdir(parents=True, exist_ok=True)
    shutil.copy(HERE / "traffic" / "motion_words.txt",
                home / "traffic" / "motion_words.txt")
    keep = [w for w in bench["workloads"] if w["name"] in cells]
    for w in keep:
        conf = tiny_conf(w["config"])
        (home / "configs" / f"{w['config']}.json").write_text(
            json.dumps(conf))
        (home / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(tiny_traffic(w["traffic"], batch)))
        lim = json.loads((HERE / "workloads" / f"{w['name']}.json")
                         .read_text())
        if limits:
            lim["limits"].update(limits)
        (home / "workloads" / f"{w['name']}.json").write_text(
            json.dumps(lim))
    bench = copy.deepcopy(bench)
    bench["workloads"] = keep
    used = {w["config"] for w in keep}
    bench["configs"] = [c for c in bench["configs"] if c["name"] in used]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return home
