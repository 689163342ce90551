"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W): tensor-core operations a second by the arithmetic a cell
states, and the HBM3 rate. The f32-accurate arms (3xTF32, IEEE) are held to
the TF32 rate."""
FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 495e12}
MFU_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


def least_seconds(flops: float, nbytes: float, arith: str) -> float:
    """The least time the card could take: operations over the peak of the
    arithmetic, or bytes over the memory rate, whichever is larger."""
    return max(flops / FLOPS[arith], nbytes / HBM_BYTES_S)
