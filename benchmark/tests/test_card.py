"""On the card (marked ``card``; skipped without one): each cell's
program on three seeds reads inside every limit, and its control, the
reference one arithmetic below the cell's in the program's place, fails
one at least, at the cell's own size. ``benchmark/calibrate.py`` makes the
same readings over more seeds; the limits were set from those."""
import pytest

from benchmark import calibrate, core
from benchmark.core import ROOT, load_json

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_inside_and_control_outside_the_limits(card, cell):
    res = calibrate.calibrate(cell, [7001, 7002, 2 ** 31 + 7003],
                              [7101, 7102, 7103], "cuda", log=lambda s: None)
    limits = core.Cell(cell).limits
    for seed, numbers in res["program"].items():
        assert core.correct_of(core.checks(numbers, limits), 0), (seed,
                                                                  numbers)
    for seed, numbers in res["control"].items():
        assert not core.correct_of(core.checks(numbers, limits), 0), (
            seed, numbers)
