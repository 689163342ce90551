"""K4, the text tower's causal attention (``csrc/flash_causal.cu``). A
launch: BH heads of S tokens, head width Dh, element bytes; query i needs
keys 0..i."""
PATTERNS = (r"(^|[\s:])causal_kernel[<(]",)


def work(l: dict):
    bh, s, dh = l["BH"], l["S"], l["Dh"]
    return 4 * bh * dh * s * (s + 1) // 2, l["elem"] * 4 * bh * s * dh
