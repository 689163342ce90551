"""The serving-precision path of the port (``utils/precision.py``) against
the JAX package, on the CPU at tiny widths.

XLA on the CPU ignores the matmul precision (a "default" dot equals a
"highest" one there), so each piece is held to what JAX computes
explicitly: the setting each serving stage takes and the K1 / K5 weight
arm it picks, for every arm of JAX's study (spies on the weight_dtype its
fused forwards receive inside the scopes); the "default" GEMM, forward and
backward, against ``lax.dot_general`` of bf16-cast operands with an f32
result (1e-5 of scale); the slice at "highest" with both variables set,
against JAX at test_torch_generate.py's bar and bit for bit against the
port with them unset; the evaluators under "default", bit-identical; the
copy of ``precision_decide`` against its original; the study's report
against the JAX script's, on a fabricated workdir; and the profiler
parser on a CPU trace.
"""
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mld_tpu  # noqa: F401  (sets JAX's session precision)
import mld_tpu.ops.fused_denoiser as jax_fused_denoiser
import mld_tpu.ops.fused_seq_decoder as jax_fused_seq_decoder
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.models.mld import lengths_to_mask as jax_lengths_to_mask

from mld_tpu_torch.config import config_to_dict, load_config
from mld_tpu_torch.models.mld import MLD, lengths_to_mask
from mld_tpu_torch.ops import fused_denoiser, fused_seq_decoder
from mld_tpu_torch.ops.fused_seq_decoder import tf32_split
from mld_tpu_torch.utils import precision

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"model": {"latent_dim": 64, "ff_size": 128, "num_layers": 3,
                   "denoiser_num_layers": 3, "num_heads": 4,
                   "text_encoded_dim": 48, "clip_layers": 2,
                   "clip_heads": 2, "clip_compute_dtype": "float32",
                   "scheduler": {"num_inference_timesteps": 3}},
         "dataset": {"max_motion_len": 40}}
TEXTS = ["a man kicks something with his left leg.",
         "a person walks backward slowly.", "someone jumps"]
LENGTHS = [40, 23, 31]
VARS = ("MLD_TPU_MATMUL_PRECISION", "MLD_TPU_STAGE_PRECISION")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_STUDY = _jax_script("precision_study")
JAX_DECIDE = _jax_script("precision_decide")


@pytest.fixture(autouse=True)
def _no_precision_vars(monkeypatch):
    for name in VARS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def tiny():
    """A port model (K1 and K5 on: their plain versions on the CPU) and a
    JAX model of the same config and weights."""
    cfg = load_config(preset="mld_humanml3d", overrides=SMALL)
    tmld = MLD(cfg, device="cpu", fused_denoiser=True, fused_decode=True,
               generator=torch.Generator().manual_seed(0))
    jmld = JaxMLD(jax_load_config(preset="mld_humanml3d", overrides=SMALL))
    params = jax.tree_util.tree_map(jnp.asarray, tmld.params_tree())
    return tmld, jmld, params


def _init(tmld, seed=3):
    return torch.randn(len(TEXTS), tmld.latent_size, tmld.latent_dim,
                       generator=torch.Generator().manual_seed(seed))


# ----------------------------------------------------------- the settings
def _jax_arm(jmld, params, prec, monkeypatch):
    """JAX's setting in each stage and the weight_dtype its K1 and K5
    forwards receive there, under session `prec` (the env's spec read by
    ``MLD._stage_precision``)."""
    seen = {}

    def spy(key):
        def fn(*args, weight_dtype=None, **kw):
            seen[key] = weight_dtype
            return args[1]     # the sample / the latent: shapes only
        return fn

    monkeypatch.setattr(jax_fused_denoiser, "fused_denoiser_forward",
                        spy("K1"))
    monkeypatch.setattr(jax_fused_seq_decoder, "fused_vae_decode",
                        spy("K5"))
    monkeypatch.setenv("MLD_TPU_FUSED_DENOISER", "1")
    monkeypatch.setenv("MLD_TPU_FUSED_DECODE", "1")
    names = {}
    z = jnp.zeros((2, 1, 64))
    with jax.default_matmul_precision(prec):
        for stage in precision.STAGES:
            with JaxMLD._stage_precision(stage):
                names[stage] = jax.config.jax_default_matmul_precision
        with JaxMLD._stage_precision("scan"):
            jmld.denoise(params, z, 5, jnp.zeros((2, 1, 48)))
        jmld.decode_latent(params, z, jnp.ones((2, 40), bool))
    dtype = {k: torch.bfloat16 if v == jnp.bfloat16 else torch.float32
             for k, v in seen.items()}
    return names, dtype


def _port_arm(tmld, monkeypatch):
    """The port's setting in each stage, and the weight dtype of the stacks
    K1 and K5 take in a generate call."""
    names = {}
    for stage in precision.STAGES:
        with precision.stage_precision(stage):
            names[stage] = precision.current()
    seen = {}
    k1, k5 = fused_denoiser.skip_encoder_stack, \
        fused_seq_decoder.skip_decoder_stack

    def spy_k1(x, st, *a):
        seen["K1"] = st.wqkv.dtype
        return k1(x, st, *a)

    def spy_k5(tgt, mem, valid, st, *a):
        seen["K5"] = st.wqkv_s.dtype
        return k5(tgt, mem, valid, st, *a)

    monkeypatch.setattr(fused_denoiser, "skip_encoder_stack", spy_k1)
    monkeypatch.setattr(fused_seq_decoder, "skip_decoder_stack", spy_k5)
    mask = lengths_to_mask(LENGTHS, tmld.max_frames, "cpu")
    out = tmld.generate_joints(tmld.tokenize(TEXTS), mask,
                               init_latents=_init(tmld))
    assert torch.isfinite(out).all()
    return names, seen


# JAX's other names for the three settings, as the session's precision
SESSION_ARMS = {f"session_{name}": (name, "")
                for name in ("bfloat16", "tensorfloat32", "float32")}


@pytest.mark.parametrize("arm", list(JAX_STUDY.ARMS) + list(SESSION_ARMS))
def test_every_study_arm_takes_jax_settings_and_weight_arms(arm, tiny,
                                                            monkeypatch):
    tmld, jmld, params = tiny
    prec, spec = {**JAX_STUDY.ARMS, **SESSION_ARMS}[arm]
    monkeypatch.setenv("MLD_TPU_STAGE_PRECISION", spec)
    want_names, want_dtype = _jax_arm(jmld, params, prec, monkeypatch)
    monkeypatch.setenv("MLD_TPU_MATMUL_PRECISION", prec)
    names, dtype = _port_arm(tmld, monkeypatch)
    assert names == want_names
    assert dtype == want_dtype and set(dtype) == {"K1", "K5"}


def test_fastest_gemms_in_bf16_on_the_f32_stacks(tiny, monkeypatch):
    # this JAX refuses the name; its weight arm is bf16 only under
    # "default" / "bfloat16" (mld_tpu/models/mld.py:308, 382), so "fastest"
    # computes its GEMMs in bf16 and streams K1's and K5's f32 stacks
    tmld, _, _ = tiny
    with pytest.raises(ValueError):
        with jax.default_matmul_precision("fastest"):
            pass
    monkeypatch.setenv("MLD_TPU_MATMUL_PRECISION", "fastest")
    assert precision.arithmetic() == "bf16"
    names, dtype = _port_arm(tmld, monkeypatch)
    assert names == {stage: "fastest" for stage in precision.STAGES}
    assert dtype == {"K1": torch.float32, "K5": torch.float32}


def test_unknown_names_raise(tiny, monkeypatch):
    tmld, _, _ = tiny
    for bad in ("bogus", "BF16_BF16_F32"):
        with pytest.raises(ValueError, match="unknown matmul precision"):
            with precision.matmul_precision(bad):
                pass
    monkeypatch.setenv("MLD_TPU_MATMUL_PRECISION", "bogus")
    with pytest.raises(ValueError, match="unknown matmul precision"):
        precision.current()
    monkeypatch.setenv("MLD_TPU_MATMUL_PRECISION", "highest")
    for spec, what in (("scan=bogus", "unknown matmul precision"),
                       ("vae=default", "bad MLD_TPU_STAGE_PRECISION"),
                       ("scan", "bad MLD_TPU_STAGE_PRECISION")):
        monkeypatch.setenv("MLD_TPU_STAGE_PRECISION", spec)
        with pytest.raises(ValueError, match=what):
            tmld.generate_joints(tmld.tokenize(TEXTS[:1]),
                                 lengths_to_mask(LENGTHS[:1], 40, "cpu"))
    with pytest.raises(ValueError, match="unknown serving stage"):
        precision.stage_precision("vae")


def test_scopes_restore_and_training_sites_keep_the_session(tiny,
                                                            monkeypatch):
    tmld, _, _ = tiny
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    with precision.matmul_precision("high"):
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        with precision.matmul_precision("default"):
            assert precision.arithmetic() == "bf16"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert precision.current() == "high"
    assert precision.current() == "highest"
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == saved

    monkeypatch.setenv("MLD_TPU_STAGE_PRECISION", "clip=default,decode=high")
    seen = []
    for module in (tmld.clip, tmld.vae):
        monkeypatch.setattr(module, "decode" if module is tmld.vae
                            else "forward", _recording(module, seen))
    ids = tmld.tokenize(TEXTS[:1])
    z = torch.zeros(1, 1, 64)
    mask = lengths_to_mask([40], 40, "cpu")
    tmld.encode_text_tokens(ids)
    tmld.encode_text_tokens(ids, serving=False)
    tmld.decode_latent(z, mask, training=True)
    tmld.decode_latent(z, mask, training=True, serving=False)
    assert seen == ["default", "highest", "high", "highest"]


def _recording(module, seen):
    fn = module.decode if hasattr(module, "decode") else module.forward

    def call(*args, **kw):
        seen.append(precision.current())
        return fn(*args, **kw)
    return call


# --------------------------------------------------------------- the GEMMs
def test_default_gemm_matches_jax_bf16_dot():
    rs = np.random.RandomState(0)
    x = rs.randn(6, 5, 96).astype(np.float32)
    w = rs.randn(40, 96).astype(np.float32)
    b = rs.randn(40).astype(np.float32)
    g = rs.randn(6, 5, 40).astype(np.float32)

    def dot(a, c):
        return np.asarray(jax.lax.dot_general(
            jnp.asarray(a, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16),
            (((a.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32))

    want = dot(x, w.T) + b
    want_gx = dot(g, w)
    want_gw = dot(g.reshape(-1, 40).T, x.reshape(-1, 96))
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    with precision.matmul_precision("default"):
        y = precision.linear(tx, tw, tb)
    gx, gw, gb = torch.autograd.grad(y, (tx, tw, tb), torch.from_numpy(g))
    for got, ref in ((y, want), (gx, want_gx), (gw, want_gw),
                     (gb, g.reshape(-1, 40).sum(0))):
        ref = np.asarray(ref)
        err = np.abs(got.detach().numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), err
    # it did round: f32 products miss the bf16 ones by far more
    assert np.abs(x @ w.T + b - want).max() > 1e-3 * np.abs(want).max()
    # "highest" is F.linear itself; bf16 operands are left as they are
    ref = torch.nn.functional.linear(tx, tw, tb)
    assert torch.equal(precision.linear(tx, tw, tb), ref)
    with precision.matmul_precision("default"):
        h = precision.linear(tx.bfloat16(), tw.bfloat16())
        assert torch.equal(h, torch.nn.functional.linear(tx.bfloat16(),
                                                         tw.bfloat16()))


def test_high_gemm_rounds_to_tf32_on_the_bits():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 2,
                      -(1 + ulp / 2), 1 + ulp * 0.75, 3.0])
    # to nearest, ties to even; TF32 keeps 10 of f32's 23 mantissa bits
    assert precision.round_bits(x, "tf32").tolist() == [
        1.0, 1.0, 1 + 2 * ulp, -1.0, 1 + ulp, 3.0]
    y = torch.randn(300, generator=torch.Generator().manual_seed(1))
    r = precision.round_bits(y, "tf32")
    assert ((r.view(torch.int32) & 8191) == 0).all()
    assert ((r - y).abs() <= y.abs() * 2.0 ** -11).all()
    # ties aside, the kernels' split (ties away) rounds alike
    assert (r != tf32_split(y)[0]).sum() <= 1
    a, w = torch.randn(8, 64), torch.randn(16, 64)
    with precision.matmul_precision("high"):
        got = precision.linear(a, w)
    want = (precision.round_bits(a, "tf32")
            @ precision.round_bits(w, "tf32").t())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert not torch.equal(got, a @ w.t())


# --------------------------------------------------------------- the slice
def test_slice_at_highest_with_the_variables_set_matches_jax(tiny,
                                                             monkeypatch):
    tmld, jmld, params = tiny
    for name in ("MLD_TPU_FUSED_DENOISER", "MLD_TPU_FUSED_DECODE"):
        monkeypatch.setenv(name, "1")
    ids = tmld.tokenize(TEXTS)
    mask = lengths_to_mask(LENGTHS, tmld.max_frames, "cpu")
    unset = tmld.generate_joints(ids, mask, init_latents=_init(tmld))
    monkeypatch.setenv("MLD_TPU_MATMUL_PRECISION", "highest")
    monkeypatch.setenv("MLD_TPU_STAGE_PRECISION",
                       "clip=highest,scan=highest,decode=highest")
    out = tmld.generate_joints(ids, mask, init_latents=_init(tmld))
    assert torch.equal(out, unset)

    rng = jax.random.PRNGKey(4)
    jmask = jax_lengths_to_mask(jnp.asarray(LENGTHS), jmld.max_frames)
    ref = np.asarray(jmld.generate_joints(params, jnp.asarray(ids.numpy()),
                                          jmask, rng))
    _, init_rng = jax.random.split(rng)
    init = np.asarray(jmld._init_latents(init_rng, len(TEXTS), jmask))
    out = tmld.generate_joints(ids, mask,
                               init_latents=torch.from_numpy(init.copy()))
    scale = np.abs(ref).max()
    err = np.abs(out.numpy() - ref).max()
    assert err <= 1e-3 * max(scale, 1.0), (err, scale)


def test_evaluators_are_bit_identical_under_default(monkeypatch):
    from mld_tpu_torch.eval.pipeline import T2MEvaluatorBundle

    cfg = load_config(preset="mld_humanml3d")
    bundle = T2MEvaluatorBundle(cfg, device="cpu", seed=0)
    rs = np.random.RandomState(0)
    feats = torch.tensor(rs.randn(3, 16, 263), dtype=torch.float32)
    words = torch.tensor(rs.randn(3, 6, 300), dtype=torch.float32)
    pos = torch.tensor(rs.rand(3, 6, 15), dtype=torch.float32)
    lens = torch.tensor([6, 4, 2])

    def run():
        return (bundle.motion_embedding(feats, torch.tensor([4, 3, 2])),
                bundle.text_embedding(words, pos, lens))

    seen = []
    move = bundle.moveencoder.forward
    monkeypatch.setattr(bundle.moveencoder, "forward",
                        lambda x: seen.append(precision.current()) or move(x))
    want = run()
    monkeypatch.setenv("MLD_TPU_MATMUL_PRECISION", "default")
    monkeypatch.setenv("MLD_TPU_STAGE_PRECISION", "clip=default")
    got = run()
    assert seen == ["highest", "highest"]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------- scripts
def test_precision_decide_copy_decides_as_the_original(tmp_path,
                                                       monkeypatch):
    from mld_tpu_torch.scripts import precision_decide as port

    for name in ("GATING", "SECONDARY", "BUDGET", "CANDIDATES"):
        assert getattr(port, name) == getattr(JAX_DECIDE, name), name
    report = os.path.join(REPO, "docs", "precision_report_r5.json")
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["precision_decide", "--report", report,
                                      "--out", str(jax_out)])
    JAX_DECIDE.main()
    decision = port.main(["--report", report, "--out", str(port_out)])
    want = json.loads(jax_out.read_text())
    got = json.loads(port_out.read_text())
    assert got == decision
    assert got.pop("device") is None
    assert got == want and got["chosen"]["arm"]


def _fabricate_workdir(root):
    """A tiny e2e workdir: the small protocol's config, a 220-clip corpus
    random trained weights and random evaluators."""
    from mld_tpu_torch.data.synthetic import build_synthetic_dataset
    from mld_tpu_torch.eval.pipeline import T2MEvaluatorBundle
    from mld_tpu_torch.eval.t2m_train import save_t2m_params
    from mld_tpu_torch.scripts import train_synthetic_e2e as e2e
    from mld_tpu_torch.utils.checkpoint import save_params_npz

    root = str(root)
    build_synthetic_dataset(os.path.join(root, "data"), n_samples=220,
                            seed=0, splits=(0.55, 0.15, 0.3))
    args = e2e.parse_args(["--workdir", root])
    cfg = load_config(None, e2e.protocol_config(args), preset=args.preset)
    with open(os.path.join(root, "cfg.json"), "w") as f:
        json.dump(config_to_dict(cfg), f)
    mld = MLD(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    save_params_npz(os.path.join(root, "trained_params.npz"),
                    mld.params_tree())
    save_t2m_params(os.path.join(root, "t2m_eval_params.npz"),
                    T2MEvaluatorBundle(cfg, device="cpu", seed=0))
    return root


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return _fabricate_workdir(tmp_path_factory.mktemp("e2e"))


def test_study_report_has_jax_keys_and_refuses_without_bundle(
        workdir, tmp_path, monkeypatch):
    from mld_tpu_torch.scripts import precision_study as port

    assert port.ARMS == JAX_STUDY.ARMS
    assert port.ARM_SEEDS == JAX_STUDY.ARM_SEEDS
    empty = str(tmp_path / "no_bundle")
    os.makedirs(empty)
    for run_eval in (port.run_eval, JAX_STUDY.run_eval):
        with pytest.raises(SystemExit, match="evaluator bundle not found"):
            run_eval(empty, "highest")
    # one intra-op thread a process: the arms run side by side
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    arms = ["highest", "gen_bf16", "noise_seed8"]
    report = port.main(["--workdir", workdir, "--arms", *arms, "--device",
                        "cpu", "--jobs", "3", "--out",
                        str(tmp_path / "port.json")])
    assert report == json.loads((tmp_path / "port.json").read_text())
    assert report.pop("_device") == {"device": "cpu"}
    # JAX's script on the port's metrics assembles the same report
    metrics = {a: {k: v for k, v in report[a].items()
                   if not k.startswith(("_", "fid_", "exceeds_"))}
               for a in arms}
    monkeypatch.setattr(JAX_STUDY, "run_eval", lambda w, prec, spec, **kw:
                        dict(metrics[[a for a in arms
                                      if JAX_STUDY.ARMS[a] == (prec, spec)
                                      and JAX_STUDY.ARM_SEEDS.get(a, 7)
                                      == kw["seed"]][0]]))
    monkeypatch.setattr(sys, "argv", ["precision_study", "--workdir",
                                      workdir, "--arms", *arms, "--out",
                                      str(tmp_path / "jax.json")])
    JAX_STUDY.main()
    assert report == json.loads((tmp_path / "jax.json").read_text())
    r5 = json.load(open(os.path.join(REPO, "docs",
                                     "precision_report_r5.json")))
    assert set(report["highest"]) == set(r5["highest"])
    assert set(report["gen_bf16"]) == set(r5["gen_bf16"])
    assert np.isfinite(report["fid_noise_floor"])


def test_train_study_runs_each_arm(workdir, tmp_path, monkeypatch):
    from mld_tpu_torch.scripts import train_precision_study as port

    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    assert port.ARMS == ("highest", "high", "default")
    report = port.main(["--workdir", workdir, "--arms", "highest", "default",
                        "--steps", "2", "--clip-steps", "2", "--device",
                        "cpu", "--jobs", "2", "--out",
                        str(tmp_path / "train.json")])
    for arm in ("highest", "default"):
        rec = report["arms"][arm]
        assert set(rec) >= {"clip_pretrain", "vae", "diffusion",
                            "eval_f32_serving"}
        assert np.isfinite(rec["diffusion"]["loss_last"])
    # the arms trained at different precisions
    assert (report["arms"]["default"]["vae"]["loss_last"]
            != report["arms"]["highest"]["vae"]["loss_last"])
    assert np.isfinite(report["arms"]["default"]["fid_rel_delta_vs_f32_train"])


def test_profile_parser_reads_a_cpu_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from mld_tpu_torch.scripts import profile_serving as prof_mod

    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            torch.nn.functional.linear(a, b).relu()
    prof.export_chrome_trace(str(tmp_path / "cpu.trace.json"))
    rows, total, lanes = prof_mod.parse_trace(str(tmp_path), 50,
                                              prof_mod.HOST_CATS)
    by_name = {name: (us, n) for name, us, n in rows}
    assert by_name["aten::relu"][1] == 5 and lanes
    assert all(us >= 0 for us, _ in by_name.values())
    assert total <= sum(float(e["dur"]) for e in json.load(
        open(tmp_path / "cpu.trace.json"))["traceEvents"]
        if e.get("cat") == "cpu_op" and e.get("ph") == "X")
    # the CUDA lane of a CPU trace is empty
    assert prof_mod.parse_trace(str(tmp_path), 5)[0] == []

    summary, rows = prof_mod.main(["--stage", "ric", "--batch", "2",
                                   "--iters", "2", "--top", "5", "--device",
                                   "cpu", "--keep", str(tmp_path / "ric")])
    assert summary["lane"] == "host" and rows
    assert summary["precision"] == "default"
