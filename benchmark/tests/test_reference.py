"""The reference against the port's plain path on the CPU, stage by stage,
at small sizes, in f32 (the port under ``highest``, its CLIP tower in f32,
K1's plain version): each stage from the same input."""
import pytest
import torch

from benchmark.families import mld_latent as fam
from benchmark.reference import arith, text
from benchmark.reference import weights as wts
from benchmark.tests import tiny

CASES = [("mld_humanml3d", "text_b128"), ("mld_humanact12", "action_b128")]


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("config,traffic", CASES)
def test_reference_matches_port_stage_by_stage(config, traffic,
                                               monkeypatch):
    for k, v in {"MLD_TPU_MATMUL_PRECISION": "highest",
                 "MLD_TPU_STAGE_PRECISION": "",
                 "MLD_TPU_FUSED_DENOISER": "1",
                 "MLD_TPU_TEXT_BUCKETS": "auto"}.items():
        monkeypatch.setenv(k, v)
    conf = tiny.tiny_conf(config)
    conf["model"]["clip_compute_dtype"] = "float32"
    mld = fam.build(conf, "cpu")
    shapes = {k: tuple(v.shape) for k, v in mld.state_dict().items()}
    w = wts.make(shapes, 5, "cpu")
    mld.load_state_dict(w, strict=True)
    c = fam.constants(conf)
    b = fam.Inputs(conf, tiny.tiny_traffic(traffic), 5, "cpu").call(1)
    condition, loop, decode, to_joints = fam._stages(w, c, "f32", "f32")
    with torch.no_grad(), arith.strict_f32():
        if c["text"]:
            ids = mld.tokenize(b["texts"])
            ref_ids = torch.as_tensor(text.tokenize(b["texts"],
                                                    c["text_buckets"]))
            assert torch.equal(ids, ref_ids)
            cond = mld.condition_embedding(ids)
            assert rel(cond, condition(ref_ids)) < 1e-5
        else:
            cond = mld.condition_embedding(b["classes_dev"])
        z = mld.diffusion_reverse(cond, init_latents=b["init"])
        assert rel(z, loop(cond, b["init"])) < 1e-5
        feats = mld.decode_latent(z, b["mask"])
        assert rel(feats, decode(z, b["mask"])) < 1e-5
        j = mld.masked_joints(feats, b["mask"])
        assert rel(j, to_joints(feats, b["mask"])) < 1e-5


def test_control_rounds_each_arithmetic():
    x = torch.randn(64, 64)
    for mode, bits in (("tf32", 10), ("bf16", 7), ("fp8", 3)):
        err = float(((arith.rounded(x, mode) - x).abs()
                     / x.abs().clamp_min(1e-3)).median())
        assert 2.0 ** -(bits + 4) < err < 2.0 ** -(bits - 1)
    assert torch.equal(arith.rounded(x, "f32"), x)
