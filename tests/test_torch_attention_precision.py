"""The bidirectional attention at the serving precision (``ops/attention.py:
sdpa`` under ``MLD_TPU_MATMUL_PRECISION``) against the JAX package, on the
CPU at small widths.

JAX's ``sdpa_xla`` (``mld_tpu/ops/attention.py:48-73``) computes its two
einsums at the matmul precision in force. XLA on the CPU ignores it, so the
reference here is ``sdpa_xla``'s formulation with each einsum's operands
rounded as a TPU rounds them (cast to bf16 under "default", TF32 on the
bits under "high") and an f32 result, the backward's four products
likewise (JAX's VJP dots inherit the precision): the forward and each of
dq, dk and dv within 1e-5 of scale, masked and unmasked, with dropout too.
"highest" is bit for bit the f32 formulation of the tree before attention
followed the setting, and bf16 tensors are left as they are.

The slice: the plain VAE decode of a small ``mld_humanml3d`` (one decoder
layer) under "default" against JAX's decode with every f32 dot rounded so
(patched ``dot_general`` and ``jnp.einsum``). One layer, because a bf16
stack is chaotic: the two packages' f32 sums differ in order, a last-bit
difference flips an operand's rounding now and then, and layer by layer the
flips grow (at three layers to 3e-3 of scale, as large as the fault
itself). At one layer the port is 5e-5 of scale from JAX's, the port with
its attention left in f32 (its arithmetic before attention followed the
setting) 3e-3 and the port at "highest" 5e-3; the bar, 5e-4 of scale,
sits between.
"""
import contextlib
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mld_tpu  # noqa: F401  (sets JAX's session precision)
from jax._src.lax import lax as jax_lax_internal
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.models.mld import MLD as JaxMLD

from mld_tpu_torch.config import load_config
from mld_tpu_torch.models.mld import MLD, lengths_to_mask
from mld_tpu_torch.ops import attention
from mld_tpu_torch.ops.attention import NEG_INF, flash_plain, sdpa
from mld_tpu_torch.utils import precision

VARS = ("MLD_TPU_MATMUL_PRECISION", "MLD_TPU_STAGE_PRECISION")
# (B, H, Sq, Sk, Dh), the valid keys of each example or None
CASES = {"self, masked": ((3, 2, 20, 20, 16), [20, 7, 1]),
         "cross, unmasked": ((2, 4, 9, 33, 32), None)}
MODES = {"default": "bf16", "high": "tf32"}
RTOL = 1e-5



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run's workers share the host's
    cores, and torch's default of one thread a core oversubscribes them
    (the decode twin took minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(autouse=True)
def _no_precision_vars(monkeypatch):
    for name in VARS:
        monkeypatch.delenv(name, raising=False)


def _jround(x, mode):
    """x as a TPU rounds a dot's f32 operand: bf16 (a bf16 array), or TF32
    to nearest even on the bits (an f32 array)."""
    if mode == "bf16":
        return x.astype(jnp.bfloat16)
    i = jax.lax.bitcast_convert_type(x, jnp.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & jnp.int32(-8192)
    return jax.lax.bitcast_convert_type(i, jnp.float32)


def _rdot(eq, a, b, mode):
    return jnp.einsum(eq, _jround(a, mode), _jround(b, mode),
                      preferred_element_type=jnp.float32)


def _reduced_einsums(mode):
    """sdpa_xla's two einsums at `mode`, each with the VJP JAX's dot takes
    at a reduced precision: every product of the backward rounds its
    operands too."""
    @jax.custom_vjp
    def qk(q, k):
        return _rdot("bhqd,bhkd->bhqk", q, k, mode)

    qk.defvjp(lambda q, k: (qk(q, k), (q, k)),
              lambda res, g: (_rdot("bhqk,bhkd->bhqd", g, res[1], mode),
                              _rdot("bhqk,bhqd->bhkd", g, res[0], mode)))

    @jax.custom_vjp
    def pv(p, v):
        return _rdot("bhqk,bhkd->bhqd", p, v, mode)

    pv.defvjp(lambda p, v: (pv(p, v), (p, v)),
              lambda res, g: (_rdot("bhqd,bhkd->bhqk", g, res[1], mode),
                              _rdot("bhqk,bhqd->bhkd", res[0], g, mode)))
    return qk, pv


def _jax_sdpa(q, k, v, valid, mode, keep=None, rate=0.0):
    """``sdpa_xla``, step for step, with its einsums at `mode` (the keep
    mask of its dropout given)."""
    qk, pv = _reduced_einsums(mode)
    scores = qk(q, k) * (1.0 / math.sqrt(q.shape[-1]))
    if valid is not None:
        scores = jnp.where(valid[:, None, None, :], scores, NEG_INF)
    probs = jax.nn.softmax(scores, axis=-1)
    if keep is not None:
        probs = jnp.where(keep, probs / (1.0 - rate), 0.0)
    return pv(probs, v)


def _inputs(shape, lengths, seed):
    B, H, Sq, Sk, Dh = shape
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, S, Dh).astype(np.float32)
               for S in (Sq, Sk, Sk))
    g = rs.randn(B, H, Sq, Dh).astype(np.float32)
    valid = (None if lengths is None
             else np.arange(Sk)[None] < np.asarray(lengths)[:, None])
    return q, k, v, g, valid


def _jax_grads(q, k, v, g, valid, mode, keep=None, rate=0.0):
    out, vjp = jax.vjp(
        lambda q_, k_, v_: _jax_sdpa(q_, k_, v_, None if valid is None
                                     else jnp.asarray(valid), mode, keep,
                                     rate),
        *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(g)))]


def _port_grads(q, k, v, g, valid, name, **kw):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tvalid = None if valid is None else torch.from_numpy(valid)
    with precision.matmul_precision(name):
        out = sdpa(tq, tk, tv, tvalid, **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    return [a.detach().numpy() for a in (out, *grads)]


def _assert_close(got, want, what):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        err = np.abs(a - b).max()
        assert err <= RTOL * np.abs(b).max(), (what, name, err)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(MODES))
def test_reduced_attention_matches_jax(case, name):
    shape, lengths = CASES[case]
    q, k, v, g, valid = _inputs(shape, lengths, seed=len(case))
    mode = MODES[name]
    want = _jax_grads(q, k, v, g, valid, mode)
    got = _port_grads(q, k, v, g, valid, name)
    _assert_close(got, want, f"{name} {case}")
    # it did round: the f32 attention (the port's at "highest", held to
    # JAX's f32 formulation by tests/test_torch_faults.py) misses the
    # reduced one by far more (bf16 keeps 8 bits, TF32 11)
    f32 = _port_grads(q, k, v, g, valid, "highest")
    floor = {"bf16": 1e-3, "tf32": 1e-4}[mode]
    for a, b in zip(f32, want):
        assert np.abs(a - b).max() > floor * np.abs(b).max()


def _f32_reference(q, k, v, valid, rate=0.0, generator=None):
    """flash_plain as the tree computed it before attention followed the
    matmul precision (every setting alike)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if valid is not None:
        scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = attention.dropout(torch.softmax(scores, dim=-1), rate, generator)
    return torch.matmul(probs, v.float()).to(q.dtype)


@pytest.mark.parametrize("case", list(CASES))
def test_highest_is_bit_identical_to_f32(case):
    shape, lengths = CASES[case]
    q, k, v, g, valid = _inputs(shape, lengths, seed=3)
    tvalid = None if valid is None else torch.from_numpy(valid)
    want = []
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = _f32_reference(tq, tk, tv, tvalid)
    want = [out.detach(), *torch.autograd.grad(out, (tq, tk, tv),
                                                torch.from_numpy(g))]
    for name in ("highest", "float32"):
        got = _port_grads(q, k, v, g, valid, name)
        for a, b in zip(got, want):
            assert torch.equal(torch.from_numpy(a), b), name
    # the session's default (the variables unset) is highest
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    assert torch.equal(sdpa(tq, tk, tv, tvalid), want[0])


@pytest.mark.parametrize("name", ["default", "high", "fastest"])
def test_bf16_tensors_are_left_as_they_are(name):
    q, k, v, _, valid = _inputs((2, 2, 12, 17, 16), [17, 5], seed=4)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    want = _f32_reference(tq, tk, tv, tvalid)
    with precision.matmul_precision(name):
        assert attention.flash_arithmetic(tq) == "f32"
        assert torch.equal(sdpa(tq, tk, tv, tvalid), want)
        with pytest.raises(ValueError, match="f32 tensors"):
            flash_plain(tq, tk, tv, tvalid, arithmetic="bf16")


@pytest.mark.parametrize("name", list(MODES))
def test_dropout_branch_rounds(name):
    """Training's attention-probability dropout (the plain version on any
    device) at a reduced precision: JAX's sdpa_xla with the same keep mask
    (the port's draws replayed) and rounded einsums."""
    rate = 0.25
    q, k, v, g, valid = _inputs((2, 2, 10, 14, 16), [14, 6], seed=5)
    gen = torch.Generator().manual_seed(11)
    u = torch.rand((2, 2, 10, 14), generator=torch.Generator().manual_seed(
        11))
    keep = jnp.asarray((u < 1.0 - rate).numpy())
    got = _port_grads(q, k, v, g, valid, name, dropout_rate=rate,
                      generator=gen)
    want = _jax_grads(q, k, v, g, valid, MODES[name], keep, rate)
    _assert_close(got, want, f"dropout {name}")


def test_flash_arithmetic_follows_the_settings(monkeypatch):
    q = torch.zeros(1, 1, 2, 4)
    assert attention.flash_arithmetic(q) == "f32"
    for name, mode in (("default", "bf16"), ("bfloat16", "bf16"),
                       ("fastest", "bf16"), ("high", "tf32"),
                       ("tensorfloat32", "tf32"), ("highest", "f32")):
        monkeypatch.setenv("MLD_TPU_MATMUL_PRECISION", name)
        assert attention.flash_arithmetic(q) == mode
        assert attention.flash_arm(q, mode) == mode
    assert attention.flash_arm(q.bfloat16(), "f32") == "bf16 tensors"
    # the decode stage's overlay reaches the attention inside its scope
    monkeypatch.setenv("MLD_TPU_MATMUL_PRECISION", "highest")
    monkeypatch.setenv("MLD_TPU_STAGE_PRECISION", "decode=default")
    with precision.stage_precision("decode"):
        assert attention.flash_arithmetic(q) == "bf16"
    with precision.stage_precision("scan"):
        assert attention.flash_arithmetic(q) == "f32"


# --------------------------------------------------------------- the slice
SMALL = {"model": {"latent_dim": 64, "ff_size": 128, "num_layers": 1,
                   "num_heads": 4, "text_encoded_dim": 48, "clip_layers": 2,
                   "clip_heads": 2}, "dataset": {"max_motion_len": 40}}
SLICE_RTOL = 5e-4


@contextlib.contextmanager
def _jax_dots(mode):
    """Every f32 dot_general of the JAX package (flax's Dense, jnp.einsum,
    which binds its own, and matmul) with its operands rounded as a TPU rounds them at `mode`
    and an f32 result; jit off, so that no trace cached without the patch
    runs."""
    orig = jax_lax_internal.dot_general

    def dot(lhs, rhs, *args, **kw):
        if lhs.dtype == jnp.float32 and rhs.dtype == jnp.float32:
            lhs, rhs = _jround(lhs, mode), _jround(rhs, mode)
            kw["preferred_element_type"] = jnp.float32
        return orig(lhs, rhs, *args, **kw)

    saved = jax.lax.dot_general, jnp.einsum
    jax.lax.dot_general = jax_lax_internal.dot_general = dot
    jnp.einsum = functools.partial(saved[1], _dot_general=dot)
    try:
        with jax.disable_jit():
            yield
    finally:
        jax.lax.dot_general, jnp.einsum = saved
        jax_lax_internal.dot_general = orig


def test_plain_vae_decode_under_default_matches_jax(monkeypatch):
    cfg = load_config(preset="mld_humanml3d", overrides=SMALL)
    tmld = MLD(cfg, device="cpu", fused_decode=False,
               generator=torch.Generator().manual_seed(0))
    jmld = JaxMLD(jax_load_config(preset="mld_humanml3d", overrides=SMALL))
    params = jax.tree_util.tree_map(jnp.asarray, tmld.params_tree())
    lengths = [40, 23, 31]
    z = np.random.RandomState(6).randn(3, 1, 64).astype(np.float32)
    mask = lengths_to_mask(lengths, 40, "cpu")
    with _jax_dots("bf16"):
        want = np.asarray(jmld.decode_latent(
            params, jnp.asarray(z), jnp.asarray(mask.numpy())))
    monkeypatch.setenv("MLD_TPU_MATMUL_PRECISION", "default")
    got = tmld.decode_latent(torch.from_numpy(z), mask).numpy()
    # today's fault: the GEMMs at bf16, the attention left in f32
    monkeypatch.setattr(attention, "flash_arithmetic", lambda q: "f32")
    fault = tmld.decode_latent(torch.from_numpy(z), mask).numpy()
    monkeypatch.undo()
    with precision.matmul_precision("highest"):
        f32 = tmld.decode_latent(torch.from_numpy(z), mask).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= SLICE_RTOL * scale
    assert np.abs(fault - want).max() > SLICE_RTOL * scale
    assert np.abs(f32 - want).max() > SLICE_RTOL * scale
