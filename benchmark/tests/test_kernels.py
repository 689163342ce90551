"""The kernel counts and the whole call's operation count."""
import pytest

from benchmark.families import mld_latent
from benchmark.kernels import k1, k3, k4, k5, peaks
from benchmark.core import load_json, HERE


@pytest.mark.parametrize("shape,sk,ms", [
    ((128, 4, 196, 64), 197, 0.0308),   # the decode, to 197 keys
    ((256, 4, 79, 64), 79, 0.0247),     # hidden mode
    ((256, 4, 198, 128), 198, 0.1240),  # raw motion
    ((12, 4, 512, 128), 512, 0.0150),   # s512
])
def test_k3_byte_bounds(shape, sk, ms):
    """PERF.md's byte bounds of K3 (f32 tensors, no key mask read)."""
    B, H, sq, dh = shape
    flops, nbytes = k3.work(dict(B=B, H=H, Sq=sq, Sk=sk, Dh=dh,
                                 keys=B * sk, elem=4, mask=False))
    assert round(nbytes / peaks.HBM_BYTES_S * 1e3, 4) == ms
    assert flops == 4 * H * sq * dh * B * sk


def test_k1_k4_k5_counts():
    f, b = k1.work(dict(n_seq=256, s=3, d=256, f=1024, n_block=4,
                        wbytes=2))
    # 9 layers of 4 d^2 + 2 d f MACs and 4 skip linears of 2 d^2, a row
    assert f == 2 * 768 * (9 * (4 * 256 ** 2 + 2 * 256 * 1024)
                           + 4 * 2 * 256 ** 2) + 4 * 256 * 9 * 256 * 9
    assert b > 2 * 7.6e6 and b < 2 * 7.7e6 + 2 * 768 * 256 * 4 + 1e5
    f4, b4 = k4.work(dict(BH=128 * 12, S=48, Dh=64, elem=2))
    assert f4 == 4 * 128 * 12 * 64 * 48 * 49 // 2
    assert b4 == 2 * 4 * 128 * 12 * 48 * 64
    f5, b5 = k5.work(dict(B=128, T=196, M=1, D=256, F=1024, n_block=4,
                          wbytes=2))
    assert f5 > 0 and b5 > 0


def test_call_flops_by_hand():
    """mld_humanml3d at B=128, bucket 48, all 196 frames valid, counted
    by hand per component."""
    conf = load_json(HERE / "configs" / "mld_humanml3d.json")
    b = {"B": 128, "bucket": 48, "lengths": [196] * 128}
    D, d, ff, T, B = 768, 256, 1024, 196, 128
    # CLIP: 12 layers of q, k, v, o (4 D^2) and fc1, fc2 (8 D^2) MACs a
    # token; causal attention QK and PV, keys 1..L a query
    tower = lambda rows, L: (rows * L * 12 * 12 * D * D * 2
                             + 12 * rows * 2 * 2 * D * sum(range(1, L + 1))
                             + rows * D * D * 2)
    text = tower(B, 48) + tower(1, 8) + 2 * B * D * d * 2
    # denoiser: 2B sequences of 3 tokens, 9 layers (4 d^2 + 2 d ff MACs a
    # token, 3 x 3 attention), 4 skip linears (2 d^2), 50 steps, and the
    # time MLP (768 -> 256 -> 256) once a step
    layer = 3 * (4 * d * d + 2 * d * ff) * 2 + 2 * 2 * 3 * 3 * d
    seq = 9 * layer + 4 * 3 * 2 * d * d * 2
    loop = 50 * (2 * B * seq + 2 * (768 * d + d * d))
    # decoder: 9 layers, a frame: self q, k, v, o (4 d^2), cross q, o
    # (2 d^2), FFN (2 d ff) MACs; the latent's k, v once a sequence; self
    # attention over 196 keys, cross over 1; 4 skip linears; final layer
    frame = 9 * (4 * d * d + 2 * d * d + 2 * d * ff) * 2 \
        + 9 * (2 * 2 * T * d + 2 * 2 * d) + 4 * 2 * d * d * 2
    decode = B * T * frame + 9 * B * 2 * d * d * 2 + B * T * d * 263 * 2
    assert mld_latent.flops(conf, b) == text + loop + decode
    # about 8 GFLOP a motion in the tower, 4.3-4.6 in the loop, 3.2-3.9 in
    # the decode (3.8 with every frame valid)
    assert 7.5e9 < text / B < 8.5e9
    assert 4.2e9 < loop / B < 4.7e9
    assert 3.1e9 < decode / B < 3.9e9


def test_launch_counts():
    conf = load_json(HERE / "configs" / "mld_humanml3d.json")
    b = {"B": 128, "bucket": 48, "lengths": [100] * 128}
    env = {"MLD_TPU_MATMUL_PRECISION": "default"}
    ls = mld_latent.launches(conf, b, env)
    assert len(ls["k1"]) == 50 and len(ls["k4"]) == 24
    assert len(ls["k3"]) == 18 and ls["k1"][0]["wbytes"] == 2
    fused = mld_latent.launches(conf, b, dict(env, MLD_TPU_FUSED_DECODE="1"))
    assert len(fused["k5"]) == 1 and len(fused["k3"]) == 9
    a2m = load_json(HERE / "configs" / "mld_humanact12.json")
    la = mld_latent.launches(a2m, {"B": 128, "bucket": 0,
                                   "lengths": [60] * 128},
                             {"MLD_TPU_MATMUL_PRECISION": "highest"})
    assert "k4" not in la and la["k1"][0]["n_block"] == 7
    assert la["k1"][0]["wbytes"] == 4 and la["k3"][0]["arith"] == "f32"


def test_k3_counts_valid_keys_only():
    """Queries and outputs at every row; keys and values, and the
    products, at the valid keys alone."""
    base = dict(B=2, H=4, Sq=196, Sk=196, Dh=64, elem=4, mask=True)
    f_all, b_all = k3.work(dict(base, keys=2 * 196))
    f_half, b_half = k3.work(dict(base, keys=196))
    assert f_all == 2 * f_half
    assert b_all - b_half == 4 * 4 * 64 * 2 * 196
    assert b_half == 4 * 4 * 64 * (2 * 2 * 196 + 2 * 196) + 2 * 196
