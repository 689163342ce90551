"""The port's joints -> SMPL fitter (``mld_tpu_torch/transforms/fitting.py``)
and fit CLI (``python -m mld_tpu_torch.fit``) against the JAX package's
(``mld_tpu/transforms/fitting.py``, ``fit.py``), on the CPU.

Inputs are made from numpy seeds: targets are the forward kinematics of a
smooth random pose walk (the settings of ``tests/test_tools.py``: T = 8,
150 Adam steps at lr 0.05, w_smooth 0.1, w_reg 1e-4). Bars:
- the cosine schedule: at most one f32 ulp from optax's at every count
  (the port takes the cosine of the f32 argument in f64 and rounds it;
  XLA's f32 cosine is not correctly rounded, so the two can differ by one
  ulp, which is up to 1.2e-7 relative);
- the GMM prior's energy: 1e-5 relative;
- the Adam phase: ``loss_curve`` within 2e-4 relative at every step, the
  final ``rot6d``, ``trans`` and ``joints_fit`` within 1e-4. The first
  gradient is bitwise JAX's; XLA fuses Adam's moment updates into FMAs
  and sums in another order, and the early steps amplify those ulps: the
  curves part by up to 1.4e-4 relative around steps 20-35 and come back
  to 1e-5 by step 80;
- one Levenberg-Marquardt step from JAX's Adam iterate: the Jacobian within
  1e-5 of ``jax.jacfwd``'s, the step within 1e-4 of its norm;
- the 15-step polish: ``joints_fit`` within 1e-3 m of JAX's (an accept or
  reject of a frame can flip at f32 rounding), MPJPE within 10% of JAX's
  and under JAX's own 0.003 bar;
- the prior on: the bars of the Adam phase;
- the CLIs on the same npy: the same file tree, the npz's ``joints_fit``
  within the polish bar and ``trans`` within 1e-3; each pkl holds its own
  fit converted (``cam`` its ``trans`` exactly, ``pose`` within 1e-4 of
  JAX's axis-angle of its ``rot6d``: a bone's twist about its own axis
  moves no joint, and there the two fits part by up to 3e-3 rad while
  their joints agree within 1e-4 m);
  the ply headers equal.
"""
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from conftest import REPO_ROOT

import mld_tpu  # noqa: F401
from mld_tpu.models.smpl import SMPLLayer as JaxSMPLLayer
from mld_tpu.models.smpl import SMPL_PARENTS
from mld_tpu.ops.rotation import axis_angle_to_matrix as jax_aa_to_matrix
from mld_tpu.ops.rotation import matrix_to_rotation_6d as jax_to_rot6d
from mld_tpu.ops.rotation import rotation_6d_to_axis_angle as jax_rot6d_to_aa
from mld_tpu.transforms.fitting import BatchedSMPLFitter as JaxFitter
from mld_tpu.transforms.fitting import GMMPosePrior as JaxPrior

from mld_tpu_torch.transforms import fitting
from mld_tpu_torch.transforms.fitting import BatchedSMPLFitter, GMMPosePrior

TEST_TOOLS_KW = dict(num_steps=150, lr=0.05, w_smooth=0.1, w_reg=1e-4)


def pose_walk(T, seed=0, scale=0.01):
    """A smooth random pose walk -> (rot6d [T, 24, 6], trans [T, 3])."""
    rng = np.random.RandomState(seed)
    ang = np.cumsum(scale * rng.randn(T, 24, 3), 0)
    rot6d = np.asarray(jax_to_rot6d(jax_aa_to_matrix(
        jnp.asarray(ang, jnp.float32))))
    trans = np.cumsum(0.01 * rng.randn(T, 3), 0).astype(np.float32)
    return rot6d, trans


def walk_joints(smpl_path=None, T=8, seed=0):
    rot6d, trans = pose_walk(T, seed)
    return np.asarray(JaxSMPLLayer(smpl_path).joints(jnp.asarray(rot6d),
                                                     jnp.asarray(trans)))


@pytest.fixture(scope="module")
def target():
    return walk_joints()


@pytest.fixture(scope="module")
def adam_pair(target):
    """The Adam phase alone, polish off, in both packages."""
    kw = dict(TEST_TOOLS_KW, polish_steps=0)
    return (JaxFitter(None, **kw).fit(target),
            BatchedSMPLFitter(None, device="cpu", **kw).fit(target))


def write_gmm(path, seed=1, K=8, D=69):
    """A seeded gmm_08.pkl: K components over D dims, covariances
    A A^T + I."""
    rng = np.random.RandomState(seed)
    A = 0.1 * rng.randn(K, D, D)
    w = rng.rand(K) + 0.5
    with open(path, "wb") as f:
        pickle.dump({"means": 0.2 * rng.randn(K, D),
                     "covars": A @ A.transpose(0, 2, 1) + np.eye(D),
                     "weights": w / w.sum()}, f)
    return path


def write_smpl(path, seed=0, V=40, J=24):
    """A SMPL-schema pickle with a small seeded body (V vertices), as
    ``tests/test_torch_a2m.py`` builds it."""
    rng = np.random.RandomState(seed)
    reg = rng.rand(J, V)
    data = {"v_template": rng.randn(V, 3) * 0.3,
            "shapedirs": rng.randn(V, 3, 10) * 0.01,
            "J_regressor": reg / reg.sum(1, keepdims=True),
            "weights": rng.dirichlet(np.ones(J), V),
            "posedirs": rng.randn(V, 3, 207) * 0.01,
            "kintree_table": np.stack(
                [[4294967295] + SMPL_PARENTS[1:], list(range(J))]),
            "f": rng.randint(0, V, (30, 3))}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def rel_err(a, b):
    return np.abs(np.asarray(a) / np.asarray(b) - 1).max()


@pytest.mark.parametrize("lr,steps", [(0.03, 300), (0.05, 150), (0.05, 800),
                                      (0.03, 50)])
def test_cosine_schedule_matches_optax(lr, steps):
    ref = np.asarray(jax.vmap(optax.cosine_decay_schedule(
        lr, steps, alpha=0.04))(jnp.arange(steps, dtype=jnp.int32)))
    out = fitting.cosine_decay(lr, steps, 0.04)
    assert out.dtype == np.float32 and out.shape == (steps,)
    np.testing.assert_array_max_ulp(out, ref, maxulp=1)


def test_gmm_energy_matches_jax(tmp_path):
    path = write_gmm(str(tmp_path / "gmm_08.pkl"))
    jp, tp = JaxPrior(path), GMMPosePrior(path)
    assert jp.available and tp.available
    pose = 0.3 * np.random.RandomState(2).randn(12, 69).astype(np.float32)
    ref = float(jp(jnp.asarray(pose)))
    out = float(tp(torch.from_numpy(pose)))
    assert abs(out / ref - 1) < 1e-5, (out, ref)
    assert not GMMPosePrior(str(tmp_path / "absent.pkl")).available


def test_adam_phase_matches_jax(adam_pair, target):
    ref, out = adam_pair
    assert out["loss_curve"].shape == (150,) and out["rot6d"].shape == (
        8, 24, 6)
    assert rel_err(out["loss_curve"], ref["loss_curve"]) < 2e-4
    for k in ("rot6d", "trans", "joints_fit"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, rtol=0)
    # the JAX test's own claims hold for the port too
    assert out["loss_curve"][-1] < out["loss_curve"][0] * 0.1
    assert np.abs(out["joints_fit"][:, :22] - target[:, :22]).mean() < 0.05


def test_adam_loss_is_taken_before_each_update(target):
    """loss_curve[i] is the objective at the parameters before update i:
    its first entry is the loss of the initial pose (identity rotations at
    the root track)."""
    f = BatchedSMPLFitter(None, device="cpu", polish_steps=0, **TEST_TOOLS_KW)
    t = torch.from_numpy(target[:, :22])
    ident = fitting._identity_rot6d(8)
    first = f.objective(ident.clone(), t[:, 0].clone(), t, ident)
    _, losses = f.adam(t)
    assert losses[0].item() == first.item()


def _jax_lm_step(jf, p, targets, p0, lam):
    """One LM step of JAX's _polish, frame by frame (its scan body)."""
    def one(p, target, p0):
        r = jf._frame_residual(p, target, p0)
        J = jax.jacfwd(jf._frame_residual)(p, target, p0)
        H = J.T @ J + lam * jnp.eye(p.shape[0])
        return J, jax.scipy.linalg.solve(H, J.T @ r, assume_a="pos")
    return jax.vmap(one)(p, targets, p0)


def test_lm_step_matches_jax(adam_pair, target):
    ref, _ = adam_pair
    kw = dict(TEST_TOOLS_KW, polish_steps=15)
    jf = JaxFitter(None, **kw)
    tf = BatchedSMPLFitter(None, device="cpu", **kw)
    p0 = np.concatenate([ref["rot6d"].reshape(8, -1), ref["trans"]], -1)
    tgt = target[:, :22]
    J_ref, d_ref = map(np.asarray, _jax_lm_step(
        jf, jnp.asarray(p0), jnp.asarray(tgt), jnp.asarray(p0), 1e-3))
    # a step away from the anchor, so that its rows are not all zero
    rng = np.random.RandomState(3)
    p1 = (p0 + 1e-3 * rng.randn(*p0.shape)).astype(np.float32)
    J1_ref, d1_ref = map(np.asarray, _jax_lm_step(
        jf, jnp.asarray(p1), jnp.asarray(tgt), jnp.asarray(p0), 1e-3))
    lam = torch.full((8,), 1e-3)
    for p, Jr, dr in ((p0, J_ref, d_ref), (p1, J1_ref, d1_ref)):
        _, _, J, delta = tf.lm_step(torch.from_numpy(p), lam,
                                    torch.from_numpy(tgt),
                                    torch.from_numpy(p0))
        assert J.shape == (8, 66 + 147, 147)
        np.testing.assert_allclose(J.numpy(), Jr, atol=1e-5, rtol=0)
        gap = np.linalg.norm(delta.numpy() - dr, axis=-1)
        assert (gap <= 1e-4 * np.linalg.norm(dr, axis=-1)).all(), gap


def test_lm_step_rejects_an_indefinite_system(target):
    """H = J^T J + lam I with lam far below zero does not factor: every
    frame keeps its parameters and lam x 2.5, and nothing raises (JAX's
    Cholesky solve gives NaN there, and NaN < cost is false)."""
    tf = BatchedSMPLFitter(None, device="cpu", polish_steps=1)
    p0 = torch.cat([fitting._identity_rot6d(8).reshape(8, -1),
                    torch.from_numpy(target[:, 0])], -1)
    lam = torch.full((8,), -1e6)
    p, lam_out, _, delta = tf.lm_step(p0, lam,
                                      torch.from_numpy(target[:, :22]), p0)
    assert torch.equal(p, p0)
    assert torch.equal(lam_out, lam * 2.5)
    # a NaN in the targets is a rejected step as well
    tgt = torch.from_numpy(target[:, :22]).clone()
    tgt[3, 5, 1] = float("nan")
    p, lam_out, _, _ = tf.lm_step(p0, torch.full((8,), 1e-3), tgt, p0)
    assert torch.equal(p[3], p0[3]) and lam_out[3].item() == pytest.approx(
        2.5e-3)


def test_polish_matches_jax(target):
    kw = dict(TEST_TOOLS_KW, polish_steps=15)
    ref = JaxFitter(None, **kw).fit(target)
    out = BatchedSMPLFitter(None, device="cpu", **kw).fit(target)
    np.testing.assert_allclose(out["joints_fit"], ref["joints_fit"],
                               atol=1e-3, rtol=0)

    def mpjpe(r):
        return np.linalg.norm(r["joints_fit"][:, :22] - target[:, :22],
                              axis=-1).mean()

    assert abs(mpjpe(out) / mpjpe(ref) - 1) < 0.1, (mpjpe(out), mpjpe(ref))
    assert mpjpe(out) < 0.003
    assert out["polish_s"] > 0 and out["adam_s"] > 0


def test_prior_on_matches_jax(tmp_path, target):
    gmm = write_gmm(str(tmp_path / "gmm_08.pkl"))
    kw = dict(TEST_TOOLS_KW, polish_steps=0, gmm_path=gmm, w_prior=1e-2)
    jf = JaxFitter(None, **kw)
    tf = BatchedSMPLFitter(None, device="cpu", **kw)
    assert jf.prior.available and tf.prior.available
    ref, out = jf.fit(target), tf.fit(target)
    assert rel_err(out["loss_curve"], ref["loss_curve"]) < 2e-4
    for k in ("rot6d", "trans", "joints_fit"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, rtol=0)
    # the prior moved the fit
    off = BatchedSMPLFitter(None, device="cpu",
                            **dict(kw, gmm_path=None)).fit(target)
    assert not np.allclose(off["loss_curve"], out["loss_curve"])


def test_vertices_match_jax(tmp_path):
    """The fitter's mesh. JAX's SMPLLayer.vertices without betas raises for
    more than one pose (its root row keeps a batch of 1 and does not stack
    with the others), so its side takes zero betas, the same body."""
    smpl = write_smpl(str(tmp_path / "SMPL_NEUTRAL.pkl"))
    rot6d, trans = pose_walk(5, seed=4, scale=0.2)
    jf = JaxFitter(smpl, num_steps=1)
    with pytest.raises(ValueError):
        jf.vertices(rot6d, trans)
    ref = np.asarray(jf.smpl.vertices(jnp.asarray(rot6d), jnp.asarray(trans),
                                      jnp.zeros((5, 10))))
    out = BatchedSMPLFitter(smpl, num_steps=1, device="cpu").vertices(
        rot6d, trans)
    assert out.shape == (5, 40, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_fitter_defaults_to_the_card(monkeypatch, tmp_path, target):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedSMPLFitter(None)
    from mld_tpu_torch import fit as port_fit
    np.save(tmp_path / "walk.npy", target)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fit.main(["--dir", str(tmp_path), "--steps", "1"])
    assert not (tmp_path / "walk_fit.npz").exists()


def _jax_fit_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_fit_cli", os.path.join(REPO_ROOT, "fit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_fit_cli_matches_fit_py(tmp_path, monkeypatch):
    """Both CLIs on the same joints npy (T = 20, 50 Adam steps, the default
    25-step polish, --ply on a 40-vertex seeded body with a seeded
    gmm_08.pkl beside it), each in a directory of its own."""
    assets = tmp_path / "assets"
    assets.mkdir()
    smpl = write_smpl(str(assets / "SMPL_NEUTRAL.pkl"))
    write_gmm(str(assets / "gmm_08.pkl"))
    joints = walk_joints(smpl, T=20, seed=5)
    dirs = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        np.save(d / "walk_20_batch0_0.npy", joints)
        dirs[side] = str(d)
    argv = ["--smpl", smpl, "--steps", "50", "--ply"]
    # fit.py's mesh export raises for T > 1 (JAX's vertices without betas,
    # test_vertices_match_jax): its fitter takes zero betas, the same body
    monkeypatch.setattr(JaxFitter, "vertices", lambda self, r, t: np.asarray(
        self.smpl.vertices(jnp.asarray(r), jnp.asarray(t),
                           jnp.zeros((len(r), 10)))))
    monkeypatch.setattr(sys, "argv", ["fit.py", "--dir", dirs["jax"]] + argv)
    _jax_fit_cli().main()
    from mld_tpu_torch import fit as port_fit
    rows = port_fit.main(["--dir", dirs["port"], "--device", "cpu"] + argv)
    assert [r["frames"] for r in rows] == [20]

    tree = _tree(dirs["jax"])
    assert _tree(dirs["port"]) == tree
    assert "walk_20_batch0_0_fit.npz" in tree
    assert "walk_20_batch0_0_mesh.npy" in tree
    assert len([f for f in tree if f.endswith(".ply")]) == 20
    ref = np.load(os.path.join(dirs["jax"], "walk_20_batch0_0_fit.npz"))
    out = np.load(os.path.join(dirs["port"], "walk_20_batch0_0_fit.npz"))
    assert sorted(out.files) == sorted(ref.files)
    np.testing.assert_allclose(out["joints_fit"], ref["joints_fit"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(out["trans"], ref["trans"], atol=1e-3, rtol=0)
    assert rows[0]["mpjpe"] == pytest.approx(float(np.linalg.norm(
        out["joints_fit"][:, :22] - joints[:, :22], axis=-1).mean()))
    sub = os.path.join("results_smplfitting", "SMPLFit_walk_20_batch0_0")
    for i in (0, 7, 19):
        name = os.path.join(sub, f"motion_{i:04d}")
        with open(os.path.join(dirs["jax"], name + ".pkl"), "rb") as f:
            pr = pickle.load(f)
        with open(os.path.join(dirs["port"], name + ".pkl"), "rb") as f:
            po = pickle.load(f)
        assert sorted(po) == sorted(pr) == ["beta", "cam", "pose"]
        for k in ("beta", "pose", "cam"):
            assert po[k].shape == pr[k].shape and po[k].dtype == pr[k].dtype
        # each side's pkl is its own fit, converted: the fits are held
        # above (joints_fit); here the conversion, against JAX's
        np.testing.assert_array_equal(po["beta"], pr["beta"])
        np.testing.assert_array_equal(po["cam"], out["trans"][i][None])
        np.testing.assert_array_equal(pr["cam"], ref["trans"][i][None])
        np.testing.assert_allclose(po["pose"], np.asarray(
            jax_rot6d_to_aa(jnp.asarray(out["rot6d"][i]))).reshape(1, 72),
            atol=1e-4, rtol=0)

        def header(path):
            with open(path) as f:
                lines = f.read().splitlines()
            return lines[: lines.index("end_header") + 1], len(lines)

        assert (header(os.path.join(dirs["port"], name + ".ply"))
                == header(os.path.join(dirs["jax"], name + ".ply")))
