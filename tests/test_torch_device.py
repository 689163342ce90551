"""The port's entry points run on the card unless the caller asks for the CPU.

``MLD`` and ``lengths_to_mask`` (given a list, no tensor to take a device
from) default to the card; with no CUDA device visible that default raises
instead of quietly building on the CPU, and ``device="cpu"`` builds there.
CUDA's absence is forced with monkeypatch, so these tests mean the same on a
host with a card.
"""
import inspect

import pytest
import torch

from mld_tpu_torch.config import load_config
from mld_tpu_torch.models.mld import MLD, lengths_to_mask, resolve_device

SMALL = {"model": {"latent_dim": 64, "ff_size": 128, "num_layers": 3,
                   "denoiser_num_layers": 3, "num_heads": 4,
                   "text_encoded_dim": 48, "clip_layers": 2,
                   "clip_heads": 2, "clip_compute_dtype": "float32"},
         "dataset": {"max_motion_len": 40}}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_mld_defaults_to_the_card():
    assert inspect.signature(MLD).parameters["device"].default == "cuda"


@pytest.mark.parametrize("preset", ["mld_humanml3d", "novae_humanml3d"])
def test_mld_default_raises_without_cuda(no_cuda, preset):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MLD(load_config(preset=preset, overrides=SMALL))


@pytest.mark.parametrize("preset", ["mld_humanml3d", "novae_humanml3d"])
def test_mld_builds_on_the_cpu_when_asked(no_cuda, preset):
    mld = MLD(load_config(preset=preset, overrides=SMALL), device="cpu")
    assert mld.device == torch.device("cpu")
    assert {p.device.type for p in mld.parameters()} == {"cpu"}
    assert mld.tokenize(["walk"]).device.type == "cpu"


def test_resolve_device(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_lengths_to_mask_device(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lengths_to_mask([3, 1], 4)
    mask = lengths_to_mask([3, 1], 4, "cpu")
    assert mask.tolist() == [[True, True, True, False],
                             [True, False, False, False]]
    # a tensor of lengths keeps its own device
    assert lengths_to_mask(torch.tensor([2]), 3).tolist() == [
        [True, True, False]]


def test_evaluation_defaults_to_the_card():
    from mld_tpu_torch.eval import __main__ as eval_cli
    from mld_tpu_torch.eval.pipeline import T2MEvaluatorBundle
    from mld_tpu_torch.eval.t2m_train import train_t2m_evaluator
    assert (inspect.signature(T2MEvaluatorBundle).parameters["device"].default
            == "cuda")
    assert (inspect.signature(train_t2m_evaluator).parameters["device"]
            .default == "cuda")
    assert eval_cli.parse_args([]).device == "cuda"


def test_evaluation_raises_without_cuda(no_cuda):
    from mld_tpu_torch.eval import __main__ as eval_cli
    from mld_tpu_torch.eval.pipeline import T2MEvaluatorBundle
    cfg = load_config(preset="mld_humanml3d", overrides=SMALL)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T2MEvaluatorBundle(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        eval_cli.main([])


def test_evaluator_builds_on_the_model_device(no_cuda):
    from mld_tpu_torch.eval.pipeline import Evaluator
    cfg = load_config(preset="mld_humanml3d", overrides=SMALL)
    mld = MLD(cfg, device="cpu")
    ev = Evaluator(cfg, mld, datamodule=None)
    assert {p.device.type for p in ev.bundle.parameters()} == {"cpu"}
    assert not any(p.requires_grad for p in ev.bundle.parameters())
