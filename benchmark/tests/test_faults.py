"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a cell can have, and when the control (the reference
one arithmetic below the cell's, in the program's place) stands in for
the program; a sound run comes out true. Tiny cells on the CPU, judged
with the cells' own limits; the run skips only the look for a card."""
import pytest
import torch

from benchmark import core
from benchmark.reference import weights as wts
from benchmark.tests import tiny
from mld_tpu_torch.diffusion.schedulers import DDIMScheduler
from mld_tpu_torch.models.denoiser import MldDenoiser
from mld_tpu_torch.models.mld import MLD

CELLS = ("t2m_b128", "a2m_b128", "t2m_b128_highest", "t2m_b512")


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    return tiny.make_home(tmp_path_factory.mktemp("bench"), cells=CELLS)


def run(home, cell, seed=5):
    return core.execute(cell, seed, 0.3, False, "cpu", env=tiny.CPU_ENV,
                        home=home)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(home, cell):
    res = run(home, cell)
    assert res["correct"], res["checks"]
    threads = core.Cell(cell, home=home).spec.get("cpu_threads")
    if threads:                  # the mix's deployment setting is applied
        assert torch.get_num_threads() == threads


def step_unchanged(monkeypatch):
    monkeypatch.setattr(DDIMScheduler, "step",
                        lambda self, out, t, sample, noise=None: sample)


def half_batch(monkeypatch):
    """The denoiser runs the first half of its batch; the rest gets the
    mean of those rows."""
    orig = MldDenoiser.fused_forward

    def half(self, sample, t, cond, time_emb=None, cond_lat=None):
        n = sample.shape[0] // 2
        out = orig(self, sample[:n], t, cond[:n], time_emb,
                   None if cond_lat is None else cond_lat[:n])
        rest = out.mean(0, keepdim=True).expand(sample.shape[0] - n,
                                                *out.shape[1:])
        return torch.cat([out, rest])
    monkeypatch.setattr(MldDenoiser, "fused_forward", half)


def token_altered(monkeypatch):
    """One id of the first prompt (text) or one class (action) changed
    where it is produced."""
    tok, emb = MLD.tokenize, MLD.condition_embedding

    def tokenize(self, texts):
        ids = tok(self, texts).clone()
        ids[0, 1] = ids[0, 1] % 1000 + 1
        return ids

    def condition_embedding(self, cond):
        if self.condition == "action":
            cond = cond.clone()
            cond[0] = (cond[0] + 1) % self.cfg.model.nclasses
        return emb(self, cond)
    monkeypatch.setattr(MLD, "tokenize", tokenize)
    monkeypatch.setattr(MLD, "condition_embedding", condition_embedding)


def answer_altered(monkeypatch):
    """The first motion's joints scaled by 1.1 where they are made."""
    orig = MLD.masked_joints

    def masked_joints(self, feats, mask):
        out = orig(self, feats, mask).clone()
        out[0] *= 1.1
        return out
    monkeypatch.setattr(MLD, "masked_joints", masked_joints)


def row_pair_altered(monkeypatch):
    """The denoiser's output for one CFG row pair (the first motion's
    unconditional and conditional rows) zeroed at every step."""
    orig = MldDenoiser.fused_forward

    def pair(self, sample, t, cond, time_emb=None, cond_lat=None):
        out = orig(self, sample, t, cond, time_emb, cond_lat).clone()
        out[0] = 0.0
        out[sample.shape[0] // 2] = 0.0
        return out
    monkeypatch.setattr(MldDenoiser, "fused_forward", pair)


FAULTS = [step_unchanged, half_batch, token_altered, answer_altered,
          row_pair_altered]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_makes_run_incorrect(home, cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(home, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 4, 2 ** 31 + 5])
def test_control_is_not_correct(home, cell, seed):
    """The reference one arithmetic below the cell's, judged as the
    program's calls are, fails one of the cell's numbers at least."""
    c = core.Cell(cell, home=home)
    r = core.Run(c, seed, 0.0, False, "cpu", tiny.CPU_ENV)
    fam = c.family
    prog = fam.build(c.conf, "cpu")
    shapes = {k: tuple(v.shape) for k, v in prog.state_dict().items()}
    w = wts.make(shapes, seed, "cpu")
    inputs = fam.Inputs(c.conf, c.spec, seed, "cpu")
    recs = [(n, fam.control(w, inputs.call(n), c.conf, r.env))
            for n in range(c.spec["pool"])]
    numbers = fam.judge(w, recs, c.conf, c.spec, seed, "cpu", c.bars)
    assert not core.correct_of(core.checks(numbers, c.limits), 0), numbers


@pytest.fixture(scope="module")
def wide_home(tmp_path_factory):
    return tiny.make_home(tmp_path_factory.mktemp("wide"), cells=CELLS,
                          batch=24)


@pytest.mark.parametrize("cell", CELLS)
def test_fault_in_one_row_pair_fails_the_row_count(wide_home, cell,
                                                   monkeypatch):
    """At 24 motions a call one bad motion leaves the loop's 90th
    percentile inside its limit; the count of rows over the bar fails."""
    row_pair_altered(monkeypatch)
    res = run(wide_home, cell)
    chk = res["checks"]
    assert not res["correct"]
    assert chk["loop_gap"]["value"] <= chk["loop_gap"]["limit"], chk
    assert chk["loop_rows_over"]["value"] > chk["loop_rows_over"]["limit"]
