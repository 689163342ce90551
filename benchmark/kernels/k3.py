"""K3, bidirectional attention (``csrc/flash_attention.cu``: the 3xTF32
``flash_kernel`` and the reduced arms ``flash_reduced_kernel`` /
``flash_reduced_long_kernel``). A launch: B, H, Sq, Sk, Dh, `keys` (the
valid keys summed over the batch), element bytes and whether a key mask is
read. Each example reads its queries and writes its outputs at every row,
and reads the keys and values of its valid keys alone."""
PATTERNS = (r"(^|[\s:])flash_kernel[<(]", r"(^|[\s:])flash_reduced_kernel[<(]",
            r"(^|[\s:])flash_reduced_long_kernel[<(]")


def work(l: dict):
    B, H, sq, sk, dh = l["B"], l["H"], l["Sq"], l["Sk"], l["Dh"]
    flops = 4 * H * sq * dh * l["keys"]
    nbytes = l["elem"] * H * dh * (2 * B * sq + 2 * l["keys"])
    return flops, nbytes + (B * sk if l["mask"] else 0)
