"""The raw-motion family (``novae_humanml3d``: the trans_dec denoiser over
the frames, CFG, ancestral DDPM) in the port against the benchmark's plain
reference (``benchmark/reference/raw.py``, plain torch, no kernel), on
seeded random weights at a small size on the CPU: d 64, 2 heads, 3 layers,
16 frames, 10 train timesteps, a 2-layer f32 text tower.

Bars: the f32 arms compute the same operations in another order, so they
meet within 1e-5 of scale (they read 4e-7). One denoiser call's bf16 arms
round the same operands to bf16, but a rounding flipped by a summation
order (LayerNorm's, the attention's) moves an operand by 2^-8 now and then:
they read 4.3e-4 apart, within 1.5e-3, while the f32 reference stands 5e-3
from the port's bf16 arm (so bf16 ran). Over the loop the flips compound,
so the port's bf16 loop is held, as the benchmark's judge holds it, to the
f32 reference: 5e-3 apart, within 0.015, where the fp8 reference (the
control, one arithmetic below) reads 0.064. Each planted fault (one step's
noise not added, the CFG halves swapped) misses the f32 bar by orders of
magnitude.
"""
import numpy as np
import pytest
import torch

from benchmark.families import mld_raw as fam
from benchmark.reference import arith, raw, text
from benchmark.reference import weights as wts
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.utils import precision

F32_BAR = 1e-5
BF16_BAR = 1.5e-3
LOOP_BAR = 0.015
SEED = 7
TEXTS = ["a person walks forward and waves.", "someone jumps",
         "a man kicks with his left leg then turns around."]
LENGTHS = [16, 9, 12]


def small_conf():
    conf = {"preset": "novae_humanml3d",
            "model": {"vae": False, "vae_type": "no", "condition": "text",
                      "latent_dim": 64, "ff_size": 128, "num_heads": 2,
                      "num_layers": 3, "denoiser_num_layers": 3,
                      "denoiser_arch": "trans_dec", "activation": "gelu",
                      "normalize_before": False,
                      "position_embedding": "learned",
                      "guidance_scale": 7.5, "text_encoded_dim": 48,
                      "clip_path": "", "clip_last_hidden": False,
                      "clip_layers": 2, "clip_heads": 2,
                      "clip_compute_dtype": "float32",
                      "scheduler": {"kind": "ddpm", "num_train_timesteps": 10,
                                    "beta_start": 0.00085, "beta_end": 0.012,
                                    "beta_schedule": "scaled_linear",
                                    "clip_sample": False,
                                    "variance_type": "fixed_small",
                                    "prediction_type": "epsilon"}},
            "dataset": {"njoints": 22, "nfeats": 263, "max_motion_len": 16,
                        "smpl_path": ""},
            "served": {"clip_ln_eps": 1e-5, "denoiser_ln_eps": 1e-6,
                       "text_buckets": [16, 24, 32, 48, 64], "mean": 0.0,
                       "std": 1.0}}
    return conf


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny ops over many steps: intra-op threads only add overhead when
    several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    conf = small_conf()
    mld = fam.build(conf, "cpu")
    shapes = {k: tuple(v.shape) for k, v in mld.state_dict().items()}
    w = wts.make(shapes, SEED, "cpu")
    mld.load_state_dict(w, strict=True)
    c = fam.constants(conf)
    mask = torch.arange(16)[None] < torch.tensor(LENGTHS)[:, None]
    init = torch.randn((3, 16, 263), generator=torch.Generator().manual_seed(3))
    return mld, w, c, mask, init


def rel(a, b):
    return float((a - b).norm() / b.norm())


def ids_and_cond(mld, c):
    ids = mld.tokenize(TEXTS)
    assert torch.equal(ids, torch.as_tensor(text.tokenize(TEXTS,
                                                          c["text_buckets"])))
    with torch.no_grad(), precision.matmul_precision("highest"):
        cond = mld.condition_embedding(ids)
    return ids, cond


@pytest.mark.parametrize("setting,mode", [("highest", "f32"),
                                          ("default", "bf16")])
def test_one_denoiser_call(setup, setting, mode):
    mld, w, c, mask, init = setup
    _, cond = ids_and_cond(mld, c)
    x, mask2 = torch.cat([init, init]), torch.cat([mask, mask])
    with torch.no_grad(), arith.strict_f32():
        with precision.matmul_precision(setting):
            out = mld.denoiser(x, 7, cond, mask2)
        tok = raw.cond_tokens(w, cond, mode)
        ref = raw.denoise(w, x, 7, tok, mask2, c, mode)
        f32 = raw.denoise(w, x, 7, raw.cond_tokens(w, cond, "f32"), mask2,
                          c, "f32")
    assert rel(out, ref) < (F32_BAR if mode == "f32" else BF16_BAR)
    assert torch.equal(out[~mask2], torch.zeros_like(out[~mask2]))
    if mode == "bf16":
        assert rel(out, f32) > 2 * BF16_BAR


@pytest.mark.parametrize("t", [9, 4, 0])
def test_one_ddpm_step(setup, t):
    mld, *_ = setup
    g = torch.Generator().manual_seed(t)
    x, eps, noise = (torch.randn(3, 16, 263, generator=g) for _ in range(3))
    sch = mld.scheduler
    sched = raw.schedule(10, 0.00085, 0.012)
    np.testing.assert_array_equal(sched[2],
                                  sch.schedule.alphas_cumprod)
    out = sch.step(eps, t, x, noise)
    assert rel(out, raw.ddpm_step(eps, t, x, sched, noise)) < 1e-6


def generate(mld, cond, mask, init, seed, setting="highest"):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad(), precision.matmul_precision(setting):
        return mld.diffusion_reverse(cond, g, init, mask)


def test_whole_call_with_its_noise_replayed(setup):
    mld, w, c, mask, init = setup
    ids, cond = ids_and_cond(mld, c)
    z = generate(mld, cond, mask, init, 11)
    m = mask[..., None]
    with torch.no_grad(), arith.strict_f32():
        cond_ref = fam._stages(w, c, "f32", "f32")[0](ids)
        assert rel(cond, cond_ref) < F32_BAR
        ref = raw.sample(w, cond, init, mask, 11, c, "f32")
        assert rel(z * m, ref * m) < F32_BAR
        # generate_joints draws the same noise from a generator of the seed
        with precision.matmul_precision("highest"):
            j = mld.generate_joints(ids, mask, init_latents=init,
                                    generator=torch.Generator()
                                    .manual_seed(11))
        j_ref = fam._stages(w, c, "f32", "f32")[2](ref * m, mask)
    assert rel(j, j_ref) < 1e-4
    # another noise seed is another sample
    assert rel(generate(mld, cond, mask, init, 12) * m, ref * m) > 0.01


def test_default_loop_against_the_f32_reference(setup):
    mld, w, c, mask, init = setup
    _, cond = ids_and_cond(mld, c)
    z = generate(mld, cond, mask, init, 5, "default")
    m = mask[..., None]
    with torch.no_grad(), arith.strict_f32():
        f32 = raw.sample(w, cond, init, mask, 5, c, "f32")
        control = raw.sample(w, cond, init, mask, 5, c, "fp8")
    assert 10 * F32_BAR < rel(z * m, f32 * m) < LOOP_BAR
    assert rel(control * m, f32 * m) > 2 * LOOP_BAR


def test_planted_faults_miss_the_bar(setup, monkeypatch):
    mld, w, c, mask, init = setup
    _, cond = ids_and_cond(mld, c)
    m = mask[..., None]
    with torch.no_grad(), arith.strict_f32():
        ref = raw.sample(w, cond, init, mask, 11, c, "f32")
        swapped = raw.sample(w, torch.cat(cond.chunk(2)[::-1]), init, mask,
                             11, c, "f32")
    # the CFG halves swapped
    assert rel(swapped * m, ref * m) > 1e3 * F32_BAR
    # one step's noise drawn and not added
    orig = MLD._step_noise

    def skip(self, shape, generator, dev, step_noise, i):
        noise = orig(self, shape, generator, dev, step_noise, i)
        return torch.zeros_like(noise) if i == 3 else noise

    monkeypatch.setattr(MLD, "_step_noise", skip)
    z = generate(mld, cond, mask, init, 11)
    assert rel(z * m, ref * m) > 1e3 * F32_BAR
