"""The denoiser's whole skip-connected encoder stack as one CUDA kernel.

Port of ``mld_tpu/ops/fused_layer.py:fused_skip_encoder`` (the Pallas
``_skip_encoder_kernel``). The kernel is ``csrc/skip_encoder.cu``, built by
``ops/_build.py``; ``skip_encoder_stack_plain`` is the same function in plain
PyTorch. The wrapper ``skip_encoder_stack`` takes the plain version only for
tensors on the CPU; for a CUDA tensor it launches the kernel or raises.

The per-layer weights are stacked once, when parameters are loaded
(``stack_skip_encoder``), into ``[L, in, out]`` matrices (f32, or bf16 for the
bf16-weight arm), f32 ``[L, K]`` vectors, and a copy of each matrix in the
order the kernel's tensor-core fragments read it (``pack_fragments``), which
only the kernel reads. LayerNorm eps is 1e-5, as in the TPU kernel
(``fused_layer.py:78``).

``fused_encoder_layer`` is the single fused layer (port of the Pallas
``_layer_kernel``, K2): one ``TransformerEncoderLayer`` stacked as L=1 with no
skip linears, launched through the same CUDA entry at ``n_block = 0``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build, work

MAX_S = 8            # short-sequence regime; the latent denoiser has S=3
MAX_TILE_ROWS = 32   # rows (sequences x S) a tile holds: two m16 tiles
LN_EPS = 1e-5
SMEM_LIMIT = 227 * 1024
CLUSTERS = (8, 4, 2, 1)  # blocks that can share a tile, largest first


def smem_bytes(D: int, F: int, H: int, S: int) -> int:
    """The kernel's shared memory: f32 rows of the 32-row tile for x, t and
    the QKV / FFN hidden buffer (each padded by 8 floats), the attention
    probabilities, and 12 x 256 partial sums for the products whose 16 warps
    split K."""
    return (4 * MAX_TILE_ROWS * (2 * (D + 8) + max(3 * D, F) + 8 + H * S)
            + 4 * 12 * 256)

# kernel launches made by skip_encoder_stack and by fused_encoder_layer
# (CUDA only)
LAUNCHES = 0
LAYER_LAUNCHES = 0


class StackedSkipEncoder(NamedTuple):
    """Weights of a SkipTransformerEncoder, stacked for the kernel.

    Layer order: input_blocks[0..n-1], middle_block, output_blocks[0..n-1].
    Matrices are [in, out]; the skip linears split into the rows that
    multiply x (wsx) and the popped skip (wss)."""
    wqkv: torch.Tensor   # [L, D, 3D]
    bqkv: torch.Tensor   # [L, 3D]
    wo: torch.Tensor     # [L, D, D]
    bo: torch.Tensor     # [L, D]
    ln1s: torch.Tensor   # [L, D]
    ln1b: torch.Tensor
    w1: torch.Tensor     # [L, D, F]
    b1: torch.Tensor     # [L, F]
    w2: torch.Tensor     # [L, F, D]
    b2: torch.Tensor     # [L, D]
    ln2s: torch.Tensor
    ln2b: torch.Tensor
    wsx: torch.Tensor    # [n, D, D]
    wss: torch.Tensor    # [n, D, D]
    bs: torch.Tensor     # [n, D]
    # the matrices above in the kernel's fragment order, [L or n, in * out]
    pqkv: torch.Tensor
    pwo: torch.Tensor
    pw1: torch.Tensor
    pw2: torch.Tensor
    psx: torch.Tensor
    pss: torch.Tensor


_MATRICES = ("wqkv", "wo", "w1", "w2", "wsx", "wss")
_PACKED = ("pqkv", "pwo", "pw1", "pw2", "psx", "pss")
# the C entry's weight arguments, in its order
_KERNEL_FIELDS = ("pqkv", "bqkv", "pwo", "bo", "ln1s", "ln1b", "pw1", "b1",
                  "pw2", "b2", "ln2s", "ln2b", "psx", "pss", "bs")


def pack_fragments(m: torch.Tensor) -> torch.Tensor:
    """[L, K, N] matrices -> [L, K * N] in the order the kernel's mma.sync B
    fragments read them, 16 bytes a lane: k pairs (two mma k steps: 16 rows
    in f32, 32 in bf16), in each pair the n-tiles of 8 columns, in each
    n-tile the 32 lanes (lane = 4 g + t holds column g), in each lane step 0
    then step 1 of its weights: f32 (m16n8k8, k permuted so that t <-> 2t,
    t + 4 <-> 2t + 1) rows 2t and 2t + 1 of the step; bf16 (m16n8k16) rows
    2t, 2t + 1, 2t + 8, 2t + 9. A warp's load of one n-tile is then 512
    contiguous bytes, and a run of n-tiles is contiguous."""
    L, K, N = m.shape
    if m.dtype == torch.bfloat16:
        # k = 32p + 16s + 8h + 2t + e, n = 8j + g -> (p, j, g, t, s, h, e)
        v = m.reshape(L, K // 32, 2, 2, 4, 2, N // 8, 8)
        v = v.permute(0, 1, 6, 7, 4, 2, 3, 5)
    else:
        # k = 16p + 8s + 2t + e, n = 8j + g -> (p, j, g, t, s, e)
        v = m.reshape(L, K // 16, 2, 4, 2, N // 8, 8)
        v = v.permute(0, 1, 5, 6, 3, 2, 4)
    return v.reshape(L, K * N).contiguous()


def stack_matrices(ws, weight_dtype) -> torch.Tensor:
    """torch Linear weights [out, in] -> one contiguous [L, in, out]."""
    return torch.stack([w.t() for w in ws]).to(weight_dtype).contiguous()


def stack_vectors(vs) -> torch.Tensor:
    """Vectors [K] -> one contiguous f32 [L, K]."""
    return torch.stack(list(vs)).float().contiguous()


def stack_skip_linears(skips, D: int, device, weight_dtype):
    """The U-Net skip linears (torch [D, 2D] weights) -> (wsx, wss, bs): the
    [n, D, D] rows of the [in, out] matrix that multiply x and the popped
    skip, and the f32 [n, D] bias. No skips give empty [0, ...] tensors."""
    if not skips:
        empty = torch.empty(0, D, D, dtype=weight_dtype, device=device)
        return empty, empty, torch.empty(0, D, device=device)
    return (stack_matrices((s.weight[:, :D] for s in skips), weight_dtype),
            stack_matrices((s.weight[:, D:] for s in skips), weight_dtype),
            stack_vectors(s.bias for s in skips))


@torch.no_grad()
def _stack_layers(layers, skips, D: int, device,
                  weight_dtype=torch.float32) -> StackedSkipEncoder:
    def mat(ws):
        return stack_matrices(ws, weight_dtype)

    vec = stack_vectors
    wsx, wss, bs = stack_skip_linears(skips, D, device, weight_dtype)
    mats = dict(wqkv=mat(l.self_attn.in_proj_weight for l in layers),
                wo=mat(l.self_attn.out_proj.weight for l in layers),
                w1=mat(l.linear1.weight for l in layers),
                w2=mat(l.linear2.weight for l in layers), wsx=wsx, wss=wss)
    return StackedSkipEncoder(
        bqkv=vec(l.self_attn.in_proj_bias for l in layers),
        bo=vec(l.self_attn.out_proj.bias for l in layers),
        ln1s=vec(l.norm1.weight for l in layers),
        ln1b=vec(l.norm1.bias for l in layers),
        b1=vec(l.linear1.bias for l in layers),
        b2=vec(l.linear2.bias for l in layers),
        ln2s=vec(l.norm2.weight for l in layers),
        ln2b=vec(l.norm2.bias for l in layers),
        bs=bs, **mats,
        **{p: pack_fragments(mats[m]) for p, m in zip(_PACKED, _MATRICES)})


def stack_skip_encoder(encoder, weight_dtype=torch.float32
                       ) -> StackedSkipEncoder:
    """ops.transformer.SkipTransformerEncoder -> StackedSkipEncoder, on the
    encoder's device. Matrices in `weight_dtype`, vectors in f32."""
    layers = [*encoder.input_blocks, encoder.middle_block,
              *encoder.output_blocks]
    return _stack_layers(layers, list(encoder.linear_blocks),
                         encoder.norm.normalized_shape[0],
                         encoder.norm.weight.device, weight_dtype)


def stack_encoder_layer(layer, weight_dtype=torch.float32
                        ) -> StackedSkipEncoder:
    """One ops.transformer.TransformerEncoderLayer -> a StackedSkipEncoder of
    L=1 with empty skip linears ([0, D, D] and [0, D])."""
    return _stack_layers([layer], [], layer.norm1.normalized_shape[0],
                         layer.norm1.weight.device, weight_dtype)


def _layer_norm(h, scale, bias):
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def _mm(a, w):
    # bf16 weights multiply activations rounded to bf16, accumulating in
    # f32 (the TPU kernel's _mm); f32 weights multiply f32 activations
    if w.dtype != torch.float32:
        a, w = a.to(w.dtype).float(), w.float()
    return a @ w


def skip_encoder_stack_plain(x: torch.Tensor, stacked: StackedSkipEncoder,
                             n_block: int, num_heads: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch. x [B, S, D] f32 -> [B, S, D],
    before the stack's final norm."""
    st = stacked
    B, S, D = x.shape
    H = num_heads
    scale = 1.0 / float((D // H) ** 0.5)
    stack = []
    for l in range(2 * n_block + 1):
        if l > n_block:
            i = l - n_block - 1
            x = _mm(x, st.wsx[i]) + _mm(stack.pop(), st.wss[i]) + st.bs[i]
        q, k, v = (_mm(x, st.wqkv[l]) + st.bqkv[l]).split(D, dim=-1)
        q = (q * scale).reshape(B, S, H, D // H)
        k = k.reshape(B, S, H, D // H)
        v = v.reshape(B, S, H, D // H)
        probs = torch.einsum("bqhd,bkhd->bhqk", q, k).softmax(dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, D)
        x = _layer_norm(x + _mm(attn, st.wo[l]) + st.bo[l],
                        st.ln1s[l], st.ln1b[l])
        ff = F.gelu(_mm(x, st.w1[l]) + st.b1[l])
        x = _layer_norm(x + _mm(ff, st.w2[l]) + st.b2[l],
                        st.ln2s[l], st.ln2b[l])
        if l < n_block:
            stack.append(x)
    return x


def _check(x: torch.Tensor, st: StackedSkipEncoder, n_block: int,
           num_heads: int):
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous f32 [B, S, D], got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, S, D = x.shape
    L = 2 * n_block + 1
    F_ = st.w1.shape[-1]
    if not 1 <= S <= MAX_S:
        raise ValueError(f"the kernel is for S <= {MAX_S} tokens (S={S})")
    if (D % num_heads or (D // num_heads) % 4 or D % 64 or F_ % 64
            or smem_bytes(D, F_, num_heads, S) > SMEM_LIMIT):
        raise ValueError(f"unsupported widths D={D} H={num_heads} F={F_}: "
                         f"the kernel takes D and F multiples of 64, heads "
                         f"of a multiple of 4, and a 32-row tile that fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    shapes = {"wqkv": (L, D, 3 * D), "bqkv": (L, 3 * D), "wo": (L, D, D),
              "bo": (L, D), "ln1s": (L, D), "ln1b": (L, D),
              "w1": (L, D, F_), "b1": (L, F_), "w2": (L, F_, D), "b2": (L, D),
              "ln2s": (L, D), "ln2b": (L, D), "wsx": (n_block, D, D),
              "wss": (n_block, D, D), "bs": (n_block, D)}
    shapes.update({p: (shapes[m][0], shapes[m][1] * shapes[m][2])
                   for p, m in zip(_PACKED, _MATRICES)})
    wdt = st.wqkv.dtype
    if wdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weights must be f32 or bf16, got {wdt}")
    for name, shape in shapes.items():
        t = getattr(st, name)
        want = wdt if name in _MATRICES + _PACKED else torch.float32
        if (tuple(t.shape) != shape or t.dtype != want
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(
                f"stacked.{name}: want contiguous {want} {shape} on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def seq_per_block(n_seq: int, S: int) -> int:
    """Sequences in one tile: as many as its 32 rows hold. Every tile
    streams all the weights from L2 whatever its rows, and its two m16
    tensor-core tiles share each weight it loads, so fuller tiles mean
    fewer weight reads."""
    return max(1, min(MAX_TILE_ROWS // S, n_seq))


def cluster_size(n_tiles: int, D: int, F: int, num_sms: int) -> int:
    """Blocks that share a tile, each multiplying 1/c of every product's
    columns: the largest c of CLUSTERS that keeps n_tiles x c blocks within
    the SMs and splits D and F (so 3D) into c x n-tiles of 8 columns."""
    for c in CLUSTERS:
        if n_tiles * c <= num_sms and D % (8 * c) == 0 and F % (8 * c) == 0:
            return c
    return 1


def _launch(x: torch.Tensor, st: StackedSkipEncoder, n_block: int,
            num_heads: int) -> torch.Tensor:
    _check(x, st, n_block, num_heads)
    B, S, D = x.shape
    lib = _build.library()
    out = torch.empty_like(x)
    F_ = st.w1.shape[-1]
    spb = seq_per_block(B, S)
    tiles = -(-B // spb)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    cluster = cluster_size(tiles, D, F_, sms)
    # the skip stack of each block, [blocks, n_block, 32, D]
    skip = torch.empty(tiles * cluster * n_block * MAX_TILE_ROWS * D,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mld_skip_encoder_forward(
            x.data_ptr(), out.data_ptr(), skip.data_ptr() if n_block else None,
            *(getattr(st, f).data_ptr() for f in _KERNEL_FIELDS),
            B, S, D, num_heads, F_, n_block, spb, cluster,
            int(st.wqkv.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"skip-encoder kernel launch failed: cudaError "
                           f"{err}")
    return out


def skip_encoder_stack(x: torch.Tensor, stacked: StackedSkipEncoder,
                       n_block: int, num_heads: int) -> torch.Tensor:
    """x [B, S, D] f32 -> [B, S, D], the whole stack before its final norm.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation) or raise, also when autograd
    tracks an input (the kernel has no backward)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return skip_encoder_stack_plain(x, stacked, n_block, num_heads)
    _build.check_no_grad("skip-encoder", x, *stacked)
    if x.device.type != "cuda":
        raise ValueError(f"no skip-encoder kernel for device {x.device}")
    out = _launch(x, stacked, n_block, num_heads)
    LAUNCHES += 1
    work.add("skip_encoder", work.encoder_flops(
        x.shape[0], x.shape[1], x.shape[2], stacked.w1.shape[-1], n_block))
    return out


def fused_encoder_layer(x: torch.Tensor, layer,
                        stacked: StackedSkipEncoder = None) -> torch.Tensor:
    """One post-norm encoder layer (port of ``fused_encoder_layer``,
    ``mld_tpu/ops/fused_layer.py:365``): x [B, S, D] f32, batch-first as the
    JAX wrapper takes it, + an ops.transformer.TransformerEncoderLayer ->
    [B, S, D]. LayerNorm eps 1e-5 (the kernel's), whatever the module's.

    `stacked` (from stack_encoder_layer) saves restacking per call. CPU
    tensors take the plain version (the stack at n_block = 0); CUDA tensors
    launch the kernel or raise, also when autograd tracks an input."""
    global LAYER_LAUNCHES
    if stacked is None:
        stacked = stack_encoder_layer(layer)
    H = layer.self_attn.num_heads
    if x.device.type == "cpu":
        return skip_encoder_stack_plain(x, stacked, 0, H)
    _build.check_no_grad("encoder-layer", x, *stacked)
    if x.device.type != "cuda":
        raise ValueError(f"no encoder-layer kernel for device {x.device}")
    out = _launch(x, stacked, 0, H)
    LAYER_LAUNCHES += 1
    work.add("encoder_layer", work.encoder_flops(
        x.shape[0], x.shape[1], x.shape[2], stacked.w1.shape[-1], 0))
    return out
