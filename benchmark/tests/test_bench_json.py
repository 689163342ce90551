"""BENCHMARK.json against the files it names and the contract's forms."""
import json
import re

import pytest

from benchmark import core
from benchmark.core import HERE, ROOT, load_json

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files(cell):
    c = core.Cell(cell)
    assert c.entry["chips"] == 1
    assert set(c.limits) == set(c.family.numbers(c.conf))
    assert all(v >= 0 for v in c.limits.values())
    assert {m["name"] for m in c.end_to_end} == {"motions_per_s",
                                                 "call_ms_p95", "setup_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            kernel = m["name"][: -len("_roofline")]
            assert (HERE / "kernels" / f"{kernel}.py").exists()


def test_configs_are_published_widths():
    for c in BENCH["configs"]:
        conf = load_json(ROOT / c["file"])
        assert c["file"].startswith("benchmark/configs/")
        assert conf["reduced"] == c["reduced"] == []
        assert conf["source"] == c["source"]
        m = conf["model"]
        assert (m["latent_dim"], m["ff_size"], m["num_heads"]) == (256, 1024,
                                                                   4)
        if m["condition"] == "text":
            assert (m["text_encoded_dim"], m["clip_layers"],
                    m["clip_heads"]) == (768, 12, 12)


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        reported = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(reported)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
