"""A later change adds a cell by files and entries alone: a dummy cell
(a new configuration, traffic mix and limits, and one entry) runs through
the unchanged harness."""
import json

from benchmark import core
from benchmark.tests import tiny


def test_dummy_cell_by_files_only(tmp_path):
    home = tiny.make_home(tmp_path)
    conf = tiny.tiny_conf("mld_humanml3d")
    conf["name"] = "mld_dummy"
    conf["model"]["denoiser_num_layers"] = 5
    (home / "configs" / "mld_dummy.json").write_text(json.dumps(conf))
    spec = tiny.tiny_traffic("text_b128")
    spec.update(batch=3, pool=3)
    (home / "traffic" / "text_b3.json").write_text(json.dumps(spec))
    limits = json.loads((home / "workloads" / "t2m_b128.json").read_text())
    (home / "workloads" / "dummy_b3.json").write_text(json.dumps(limits))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mld_dummy", "source": "test",
                             "file": "benchmark/configs/mld_dummy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy_b3", "config": "mld_dummy",
                               "traffic": "text_b3", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append("dummy_b3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = core.execute("dummy_b3", 11, 0.2, False, "cpu",
                       env=tiny.CPU_ENV, home=home)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"motions_per_s", "call_ms_p95",
                                   "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    traced = core.execute("dummy_b3", 12, 0.2, True, "cpu",
                          env=tiny.CPU_ENV, home=home)
    assert traced["correct"]
    assert {"text_ms", "scan_ms", "decode_ms", "joints_ms"} <= set(
        traced["metrics"])
