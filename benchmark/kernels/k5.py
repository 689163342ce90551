"""K5, the VAE decoder stack as one C entry (``csrc/skip_decoder.cu``: its
GEMMs, key mask and cross-attention kernels; its self-attention launches K3
and is counted there). A launch: B sequences of T frames, M latent tokens,
width D, FFN F, n_block, weight bytes. Counted: each row's self-attention
QKV and out projections and FFN a layer, the cross-attention (at M = 1 the
value and out projections once a sequence, its output being the value
row), a skip linear a row for each output block; bytes: the weights once,
the queries in and the output out (f32), the latent, the mask."""
PATTERNS = (r"(^|[\s:])gemm_kernel[<(]", r"(^|[\s:])key_mask_kernel[<(]",
            r"(^|[\s:])cross_attention_kernel[<(]")


def work(l: dict):
    B, T, M, D, F, nb = l["B"], l["T"], l["M"], l["D"], l["F"], l["n_block"]
    L, rows = 2 * nb + 1, B * T
    cross = (2 * B * 2 * D * D if M == 1
             else 2 * rows * 2 * D * D + 2 * B * M * 2 * D * D)
    flops = L * (2 * rows * (4 * D * D + 2 * D * F) + cross) \
        + nb * 2 * rows * 2 * D * D
    mats = L * (6 * D * D + 2 * D * F) + nb * 2 * D * D
    vecs = L * (10 * D + F + 6 * D) + nb * D
    nbytes = (mats * l["wbytes"] + 4 * vecs + 2 * 4 * rows * D
              + 4 * B * M * D + 4 * B * T)
    return flops, nbytes
