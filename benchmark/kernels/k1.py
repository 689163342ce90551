"""K1, the denoiser's U-Net-skip encoder stack in one launch
(``csrc/skip_encoder.cu``). A launch: n_seq sequences of s tokens, width d,
FFN f, 2 n_block + 1 layers, matrices of wbytes a weight (2 for the bf16
arm, 4 for f32)."""
PATTERNS = (r"(^|[\s:])skip_encoder_kernel[<(]",)


def work(l: dict):
    n, s, d, f, nb = l["n_seq"], l["s"], l["d"], l["f"], l["n_block"]
    L, rows = 2 * nb + 1, n * s
    mats = L * (4 * d * d + 2 * d * f) + nb * 2 * d * d
    flops = 2 * rows * mats + 4 * n * s * s * d * L
    vecs = L * (3 * d + d + 2 * d + f + d + 2 * d) + nb * d
    return flops, mats * l["wbytes"] + 4 * vecs + 2 * 4 * rows * d
