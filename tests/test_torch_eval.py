"""The port's evaluation protocol vs the JAX package's, on the CPU.

- The BiGRU against ``mld_tpu.ops.gru.BiGRU`` on ragged lengths, and the
  three evaluator networks at full width against the flax modules, with
  flax-initialised weights through the bridge: atol 1e-5.
- The metric modules carried as copies equal their originals' source; the
  Rifke and APE/AVE twins hold the originals within 1e-5.
- ``Evaluator.run_split`` (main, MultiModality and ground-truth passes) on a
  tiny config (D=32, 3 layers, CLIP 2 layers in f32, 64 frames, DDIM-3) over
  a 64-clip synthetic corpus (11 test clips: a batch of 8 and a ragged one of
  3), against ``mld_tpu.eval.pipeline.Evaluator`` with the same weights
  (the port initialises, JAX loads through the bridges) and JAX's initial
  latents replayed a batch:
  - lat_t / lat_m / lat_rm within 1e-4 of their scale (f32 through two
    packages' summation orders: a 3-layer denoiser over 3 DDIM steps, a
    3-layer VAE decode, then the evaluators);
  - FID, Diversity, Matching score, MultiModality and APE/AVE within 1e-4
    relative;
  - R-precision exactly equal when computed from the same embeddings; end
    to end at most one rank flip apart (1 / R_count), because two
    distances within 1e-4 of each other can trade places.
- The VAE stage's ``recon_from_motion`` with JAX's eps replayed: 1e-4 of
  the joints' scale.
"""
import inspect

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.data.datamodule import get_datamodule as jax_get_datamodule
from mld_tpu.eval.pipeline import Evaluator as JaxEvaluator
from mld_tpu.eval.pipeline import T2MEvaluatorBundle as JaxBundle
from mld_tpu.metrics import ComputeMetrics as JaxComputeMetrics
from mld_tpu.metrics import TM2TMetrics as JaxTM2TMetrics
from mld_tpu.metrics import mm as jmm
from mld_tpu.metrics import mr as jmr
from mld_tpu.metrics import tm2t as jtm2t
from mld_tpu.metrics import uncond as juncond
from mld_tpu.metrics import utils as jutils
from mld_tpu.models.clip_text import convert_hf_clip_text
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.ops.gru import BiGRU as JaxBiGRU
from mld_tpu.transforms.rifke import Rifke as JaxRifke
from mld_tpu.utils.torch_convert import torch_state_dict_to_flax

from mld_tpu_torch.config import load_config
from mld_tpu_torch.data.datamodule import get_datamodule
from mld_tpu_torch.data.synthetic import build_synthetic_dataset
from mld_tpu_torch.eval.pipeline import Evaluator, T2MEvaluatorBundle
from mld_tpu_torch.metrics import ComputeMetrics, TM2TMetrics
from mld_tpu_torch.metrics import mm, mr, tm2t, uncond, utils
from mld_tpu_torch.models.clip_text import ClipTokenizer
from mld_tpu_torch.models.mld import MLD, lengths_to_mask
from mld_tpu_torch.models.t2m_eval import (MotionEncoderBiGRUCo,
                                           MovementConvEncoder,
                                           TextEncoderBiGRUCo)
from mld_tpu_torch.ops.gru import BiGRU, bigru_plain
from mld_tpu_torch.transforms.rifke import Rifke
from mld_tpu_torch.utils.convert import flax_t2m_to_state_dict

NET_ATOL = 1e-5
EMB_RTOL = 1e-4
METRIC_RTOL = 1e-4
N_CLIPS = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ the GRU
@pytest.mark.parametrize("reverse_first", [False, True])
def test_bigru_matches_jax(reverse_first):
    B, T, I, H = 5, 13, 24, 32
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, I).astype(np.float32)
    lengths = np.array([13, 1, 7, 13, 4])
    if reverse_first:
        lengths = lengths[::-1].copy()
    h0 = rng.randn(2, B, H).astype(np.float32)
    jgru = JaxBiGRU(I, H)
    params = jgru.init(jax.random.PRNGKey(1), jnp.asarray(x),
                       jnp.asarray(lengths), jnp.asarray(h0))["params"]
    j_out, j_fin = (np.asarray(a) for a in jgru.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(lengths),
        jnp.asarray(h0)))
    gru = BiGRU(I, H)
    gru.load_state_dict({k: torch.from_numpy(v.copy())
                         for k, v in _np(params).items()}, strict=True)
    with torch.no_grad():
        out, fin = gru(torch.tensor(x), torch.tensor(lengths),
                       torch.tensor(h0))
        p_out, p_fin = bigru_plain(gru, torch.tensor(x), torch.tensor(lengths),
                                   torch.tensor(h0))
    np.testing.assert_allclose(fin.numpy(), j_fin, atol=NET_ATOL)
    np.testing.assert_allclose(p_fin.numpy(), j_fin, atol=NET_ATOL)
    np.testing.assert_allclose(p_out.numpy(), j_out, atol=NET_ATOL)
    # packed outputs stop at each length (zeros after), the scan's carry on
    valid = np.arange(T)[None] < lengths[:, None]
    np.testing.assert_allclose(out.numpy()[valid], j_out[valid],
                               atol=NET_ATOL)
    assert not out.numpy()[~valid].any()


# ----------------------------------------------------- the evaluator nets
@pytest.fixture(scope="module")
def jax_bundle():
    cfg = jax_load_config(preset="mld_humanml3d")
    return JaxBundle(cfg, seed=5)


def _port_net(cls, tree, *args):
    net = cls(*args)
    net.load_state_dict(flax_t2m_to_state_dict(_np(tree)), strict=True)
    return net.eval()


def test_text_encoder_matches_jax(jax_bundle):
    rng = np.random.RandomState(1)
    B, S = 4, 12
    we = rng.randn(B, S, 300).astype(np.float32)
    po = rng.rand(B, S, 15).astype(np.float32)
    lens = np.array([12, 3, 9, 1], np.int32)
    ref = np.asarray(jax_bundle.textencoder.apply(
        {"params": jax_bundle.params["text"]}, jnp.asarray(we),
        jnp.asarray(po), jnp.asarray(lens)))
    net = _port_net(TextEncoderBiGRUCo, jax_bundle.params["text"],
                    300, 15, 512, 512)
    with torch.no_grad():
        out = net(torch.tensor(we), torch.tensor(po), torch.tensor(lens))
    assert out.shape == (B, 512)
    np.testing.assert_allclose(out.numpy(), ref, atol=NET_ATOL)


def test_motion_encoders_match_jax(jax_bundle):
    rng = np.random.RandomState(2)
    B, T = 3, 64
    feats = rng.randn(B, T, 259).astype(np.float32)
    m_lens = np.array([16, 5, 11])
    move = _port_net(MovementConvEncoder, jax_bundle.params["move"],
                     259, 512, 512)
    motion = _port_net(MotionEncoderBiGRUCo, jax_bundle.params["motion"],
                       512, 1024, 512)
    j_mov = jax_bundle.moveencoder.apply(
        {"params": jax_bundle.params["move"]}, jnp.asarray(feats))
    j_emb = jax_bundle.motionencoder.apply(
        {"params": jax_bundle.params["motion"]}, j_mov, jnp.asarray(m_lens))
    with torch.no_grad():
        mov = move(torch.tensor(feats))
        emb = motion(mov, torch.tensor(m_lens))
    assert mov.shape == (B, T // 4, 512) and emb.shape == (B, 512)
    np.testing.assert_allclose(mov.numpy(), np.asarray(j_mov), atol=NET_ATOL)
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_emb), atol=NET_ATOL)


# ------------------------------------------------ carried copies and twins
@pytest.mark.parametrize("port, orig", [
    (utils, jutils), (tm2t, jtm2t), (mm, jmm), (uncond, juncond),
    (mr, jmr)], ids=["utils", "tm2t", "mm", "uncond", "mr"])
def test_carried_metric_copies_equal_originals(port, orig):
    names = [n for n, v in vars(orig).items()
             if (inspect.isfunction(v) or inspect.isclass(v))
             and v.__module__ == orig.__name__]
    assert names
    for name in names:
        assert (inspect.getsource(getattr(port, name))
                == inspect.getsource(getattr(orig, name))), name


def _joints(seed, B=3, T=30):
    """Smooth walking-like joints: a rest pose, a drifting root and small
    per-joint motion (the Rifke floor and heading need a plausible body)."""
    rng = np.random.RandomState(seed)
    rest = rng.randn(22, 3).astype(np.float32) * 0.3
    rest[:, 1] = np.abs(rest[:, 1]) + 0.05
    t = np.linspace(0, 2, T, dtype=np.float32)[None, :, None, None]
    drift = rng.randn(B, 1, 1, 3).astype(np.float32) * t
    wobble = 0.05 * np.sin(3 * t + rng.randn(B, 1, 22, 3))
    return (rest[None, None] + drift + wobble).astype(np.float32)


def test_rifke_matches_jax():
    joints = _joints(0)
    ref = np.asarray(JaxRifke()(jnp.asarray(joints)))
    out = Rifke()(torch.tensor(joints)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-5 * scale
    back_ref = np.asarray(JaxRifke().inverse(jnp.asarray(ref)))
    back = Rifke().inverse(torch.tensor(ref)).numpy()
    assert np.abs(back - back_ref).max() <= 1e-5 * np.abs(back_ref).max()


def test_compute_metrics_matches_jax():
    a, b = _joints(1), _joints(2)
    lengths = [30, 17, 9]
    jm, pm = JaxComputeMetrics(), ComputeMetrics()
    jm.update(a, b, lengths)
    pm.update(a, b, lengths)
    ref, out = jm.compute(), pm.compute()
    assert set(ref) == set(out)
    for k in ref:
        assert abs(out[k] - ref[k]) <= 1e-5 * abs(ref[k]), (k, out[k], ref[k])


# ----------------------------------------------------------- the protocol
def tiny_over(root):
    return {"debug": True,
            "model": {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
                      "denoiser_num_layers": 3, "num_heads": 4,
                      "text_encoded_dim": 32, "clip_layers": 2,
                      "clip_heads": 2, "clip_compute_dtype": "float32",
                      "scheduler": {"num_inference_timesteps": 3}},
            "dataset": {"root": root, "max_motion_len": 64,
                        "min_motion_len": 16, "native_loader": False},
            "eval": {"batch_size": 8, "diversity_times": 4, "r_size": 4,
                     "mm_num_samples": 2, "mm_num_repeats": 4,
                     "mm_num_times": 2}}


def jax_params_of(tmld):
    """The port model's weights as the JAX package's param tree."""
    sd = {k: v.detach().numpy().copy() for k, v in tmld.state_dict().items()}
    params = {"clip": convert_hf_clip_text(
        {k[5:]: v for k, v in sd.items() if k.startswith("clip.")})}
    for top in ("vae", "denoiser"):
        tree = torch_state_dict_to_flax(
            {k[len(top) + 1:]: v for k, v in sd.items()
             if k.startswith(top + ".")})
        if "emb_proj_1" in tree:
            tree["emb_proj"] = tree.pop("emb_proj_1")
        params[top] = jax.tree_util.tree_map(jnp.asarray, tree)
    return params


class Pair:
    """Both packages over one corpus, with the same model and evaluator
    weights; `spy` records each JAX batch's rng, rows and outputs."""

    def __init__(self, root):
        over = tiny_over(root)
        self.cfg = load_config(preset="mld_humanml3d", overrides=over)
        self.jcfg = jax_load_config(preset="mld_humanml3d", overrides=over)
        self.dm = get_datamodule(self.cfg,
                                 tokenizer=ClipTokenizer(self.cfg.model.clip_path))
        stats = dict(mean=self.dm.mean, std=self.dm.std,
                     mean_eval=self.dm.mean_eval, std_eval=self.dm.std_eval)
        self.tmld = MLD(self.cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0), **stats)
        self.jmld = JaxMLD(self.jcfg, **stats)
        self.jdm = jax_get_datamodule(self.jcfg, tokenizer=self.jmld.tokenizer)
        self.params = jax_params_of(self.tmld)
        bundle = T2MEvaluatorBundle(self.cfg, device="cpu", seed=3)
        self.tree = bundle.params_tree()
        self.ev = Evaluator(self.cfg, self.tmld, self.dm, t2m_params=self.tree)
        self.jev = JaxEvaluator(self.jcfg, self.jmld, self.jdm,
                                t2m_params=self.tree)
        self.jax_batches, self.port_batches = [], []
        jit = self.jev._eval_batch_jit

        def spy(params, text_ids, *args, stage):
            out = jit(params, text_ids, *args, stage=stage)
            self.jax_batches.append((args[-1], text_ids.shape[0],
                                     _np(out)))
            return out

        self.jev._eval_batch_jit = spy
        eval_batch = self.ev.eval_batch

        def port_spy(batch, stage, draws, mm=False):
            out = eval_batch(batch, stage, draws, mm=mm)
            self.port_batches.append((np.asarray(batch["length"]), out))
            return out

        self.ev.eval_batch = port_spy

    def draws(self, rows):
        """The initial latents JAX drew for its recorded batches
        (``mld.py:462-464``), cut to each batch's real rows."""
        out = []
        for (srng, pad_rows, _), n in zip(self.jax_batches, rows):
            _, init_rng = jax.random.split(srng)
            init = np.asarray(self.jmld._init_latents(init_rng, pad_rows,
                                                      None))
            out.append({"init_latents": torch.from_numpy(init[:n].copy())})
        return out

    def run(self, loader_args, mm=False, **kw):
        """One run_split in each package; returns (jax result, port
        result, jax batches' outputs, port batches' outputs, the port's
        batches). The batches are collected first: a dataset draws its
        caption and crop from its own RNG at every item, so each package's
        loader is iterated once, in step with the other's."""
        self.jax_batches.clear()
        self.port_batches.clear()
        jbatches = list(self.jdm.loader("test", **loader_args))
        tbatches = list(self.dm.loader("test", **loader_args))
        jres = self.jev.run_split(
            self.params, jbatches, jax.random.PRNGKey(7), mm=mm,
            compute_rng=np.random.RandomState(0), **kw)
        reps = self.cfg.eval.mm_num_repeats if mm else 1
        tres = self.ev.run_split(
            tbatches, mm=mm,
            draws=self.draws([len(b["length"]) * reps for b in tbatches]),
            compute_rng=np.random.RandomState(0), **kw)
        return (jres, tres, list(self.jax_batches), list(self.port_batches),
                tbatches)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_eval"))
    build_synthetic_dataset(root, n_samples=N_CLIPS, seed=0)
    return Pair(root)


@pytest.fixture(scope="module")
def main_pass(pair):
    return pair.run({"shuffle": False, "batch_size": 8})


def _close(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(b), 1e-12)


def test_main_pass_embeddings_match_jax(main_pass):
    _, _, jb, pb, _ = main_pass
    assert [n for _, n, _ in jb] == [8, 8]   # JAX pads the ragged batch
    assert [len(lens) for lens, _ in pb] == [8, 3]
    for (_, _, jout), (lens, pout) in zip(jb, pb):
        real = jout["align"] < len(lens)
        np.testing.assert_array_equal(jout["align"][real], pout["align"])
        for key in ("lat_t", "lat_m", "lat_rm"):
            ref = jout[key][real]
            scale = np.abs(ref).max()
            err = np.abs(pout[key] - ref).max()
            assert err <= EMB_RTOL * scale, (key, err, scale)
        for key in ("joints_rst", "joints_ref"):
            ref = jout[key][: len(lens)]
            err = np.abs(pout[key] - ref).max()
            assert err <= EMB_RTOL * max(np.abs(ref).max(), 1.0), key


def test_main_pass_metrics_match_jax(main_pass):
    jres, tres, _, _, _ = main_pass
    assert set(jres) == set(tres)
    r_count = 11 // 4 * 4
    for k, ref in jres.items():
        if "R_precision" in k:
            assert abs(tres[k] - ref) <= 1.0 / r_count + 1e-12, k
        else:
            assert _close(tres[k], ref, METRIC_RTOL), (k, tres[k], ref)
    assert all(np.isfinite(v) for v in tres.values())


def test_r_precision_equal_from_the_same_embeddings(main_pass):
    _, _, jb, _, _ = main_pass
    jm, pm = JaxTM2TMetrics(R_size=4, diversity_times=4), TM2TMetrics(
        R_size=4, diversity_times=4)
    for _, n, out in jb:
        lens = np.arange(n)   # only counted
        for acc in (jm, pm):
            acc.update(out["lat_t"], out["lat_rm"], out["lat_m"], lens)
    ref = jm.compute(rng=np.random.RandomState(3))
    got = pm.compute(rng=np.random.RandomState(3))
    for k in ref:
        if "R_precision" in k or "Matching" in k:
            assert got[k] == ref[k], k


def test_mm_pass_matches_jax(pair):
    """One text's repeats a batch, as the JAX package batches them; then
    the port's own batching (2 texts x 4 repeats a batch) with the same
    draws gives the same MultiModality."""
    pair.dm.mm_mode(True, 2, rng=np.random.RandomState(0))
    pair.jdm.mm_mode(True, 2, rng=np.random.RandomState(0))
    try:
        jres, tres, jb, pb, singles = pair.run(
            {"shuffle": False, "batch_size": 1}, mm=True)
        draws = pair.draws([4] * len(singles))
        # the same two texts as one batch, in the collator's order (by text
        # length, descending, stable)
        order = sorted(range(2), key=lambda i: singles[i]["text_len"][0],
                       reverse=True)
        joint = {k: np.concatenate([singles[i][k] for i in order])
                 for k in ("text_ids", "word_embs", "pos_ohot", "motion",
                           "mask", "length", "text_len")}
        both = pair.ev.run_split(
            [joint], mm=True, draws=[{"init_latents": torch.cat(
                [draws[i]["init_latents"] for i in order])}],
            compute_rng=np.random.RandomState(0))
    finally:
        pair.dm.mm_mode(False)
        pair.jdm.mm_mode(False)
    assert len(jb) == len(pb) == 2
    for (_, _, jout), (_, pout) in zip(jb, pb):
        ref = jout["lat_rm"]
        assert np.abs(pout["lat_rm"] - ref).max() <= EMB_RTOL * np.abs(
            ref).max()
    assert set(tres) == {"MultiModality"}
    assert _close(tres["MultiModality"], jres["MultiModality"], METRIC_RTOL)
    assert _close(both["MultiModality"], tres["MultiModality"], 1e-6)


def test_gt_pass_matches_jax(pair):
    jres = pair.jev.run_gt(pair.params,
                           list(pair.jdm.loader("test", shuffle=False)),
                           jax.random.PRNGKey(0))
    tres = pair.ev.run_gt(list(pair.dm.loader("test", shuffle=False)))
    assert set(jres) == set(tres)
    for k, ref in jres.items():
        if "R_precision" in k:
            assert abs(tres[k] - ref) <= 1.0 / 8 + 1e-12, k
        elif k != "FID":   # GT vs itself: FID is 0 up to sqrtm's rounding
            assert _close(tres[k], ref, METRIC_RTOL), (k, tres[k], ref)
    assert abs(tres["FID"]) < 1e-3 and abs(jres["FID"]) < 1e-3


def test_recon_from_motion_matches_jax(pair):
    batch = next(iter(pair.dm.loader("test", shuffle=False, batch_size=4)))
    rng = jax.random.PRNGKey(11)
    m = pair.jmld
    j_rst, j_ref = (np.asarray(a) for a in m.recon_from_motion(
        pair.params, jnp.asarray(batch["motion"]), jnp.asarray(batch["mask"]),
        rng))
    eps = np.asarray(jax.random.normal(rng, (4, m.latent_size,
                                              m.latent_dim)))
    rst, ref = pair.tmld.recon_from_motion(
        torch.from_numpy(batch["motion"]), torch.from_numpy(batch["mask"]),
        eps=torch.from_numpy(eps.copy()))
    scale = max(np.abs(j_rst).max(), 1.0)
    assert np.abs(rst.numpy() - j_rst).max() <= EMB_RTOL * scale
    assert np.abs(ref.numpy() - j_ref).max() <= EMB_RTOL * scale
    # the mask is honoured and the motions are not the input
    assert not rst.numpy()[~batch["mask"]].any()
    assert np.abs(rst.numpy() - ref.numpy()).max() > 1e-3


def test_gen_from_latent_is_the_decode(pair):
    z = torch.randn(2, pair.tmld.latent_size, pair.tmld.latent_dim,
                    generator=torch.Generator().manual_seed(0))
    mask = lengths_to_mask([64, 20], 64, "cpu")
    joints = pair.tmld.gen_from_latent(z, mask)
    want = pair.tmld.feats2joints(pair.tmld.decode_latent(z, mask))
    torch.testing.assert_close(joints, want * mask[..., None, None])


def test_strict_f32_restores_the_callers_settings():
    from mld_tpu_torch.utils.precision import matmul_precision
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with pytest.raises(KeyError):
            with matmul_precision("highest"):
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
                raise KeyError
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
