"""The VAE decoder's whole skip-connected stack through one CUDA entry.

Port of ``mld_tpu/ops/fused_seq_decoder.py`` (the Pallas ``_decoder_kernel``,
its wrapper ``fused_skip_decoder``, and ``fused_vae_decode``). The kernels are
``csrc/skip_decoder.cu``, built by ``ops/_build.py``;
``skip_decoder_stack_plain`` is the same function in plain PyTorch. The
wrapper ``skip_decoder_stack`` takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernels or raises.

The per-layer weights are stacked once, when parameters are loaded or moved
(``MldVae.restack``), in the layout of ``_stack_decoder_params``
(``fused_seq_decoder.py:141-164``) with the skip linears split into the rows
that multiply x (``wsx``) and the popped skip (``wss``): matrices ``[L, in,
out]`` in the weight dtype (f32, or bf16 for the bf16-weight arm), vectors
f32 ``[L, K]``. The kernels read copies of the matrices
(``pack_decoder_weights``): in torch's Linear layout ``[out, in]``, so that
both operands of every tensor-core product are K-major (the skip linear one
``[D, 2D]`` matrix again), f32 ones split into their TF32 part and the rest,
and cut into the tiles that one bulk copy brings into shared memory as the
tensor cores read them (``tile_weights``). LayerNorm eps is 1e-5 in every
norm, as in the TPU kernel;
the plain module path (``MldVae.decode``) keeps flax's 1e-6, so the two
decode paths differ by design (ROADMAP.md section 3).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build, work
from .attention import NEG_INF
from .fused_layer import (_layer_norm, _mm, stack_matrices,
                          stack_skip_linears, stack_vectors)

MAX_M = 8        # latent tokens the kernel takes (can_fuse_decode)
MAX_D = 256      # one GEMM block holds a whole row for the LayerNorm epilogue
MAX_DH = 128     # the self-attention kernel's (K3) head widths
WIDTH_STEP = 64  # D and F: whole weight tiles (64 rows) and bf16 stages

# kernel-entry calls made by skip_decoder_stack (CUDA only), and the device
# kernels those calls launched as the C entry counts them (launch_count()
# a call)
LAUNCHES = 0
KERNELS = 0


class StackedSkipDecoder(NamedTuple):
    """Weights of a SkipTransformerDecoder, stacked for the kernel.

    Layer order: input_blocks[0..n-1], middle_block, output_blocks[0..n-1].
    `_s` is the self-attention, `_x` the cross-attention; ln1/ln2/ln3 follow
    them and the FFN."""
    wqkv_s: torch.Tensor  # [L, D, 3D]
    bqkv_s: torch.Tensor  # [L, 3D]
    wo_s: torch.Tensor    # [L, D, D]
    bo_s: torch.Tensor    # [L, D]
    wqkv_x: torch.Tensor  # [L, D, 3D]
    bqkv_x: torch.Tensor  # [L, 3D]
    wo_x: torch.Tensor    # [L, D, D]
    bo_x: torch.Tensor    # [L, D]
    ln1s: torch.Tensor    # [L, D]
    ln1b: torch.Tensor
    ln2s: torch.Tensor
    ln2b: torch.Tensor
    ln3s: torch.Tensor
    ln3b: torch.Tensor
    w1: torch.Tensor      # [L, D, F]
    b1: torch.Tensor      # [L, F]
    w2: torch.Tensor      # [L, F, D]
    b2: torch.Tensor      # [L, D]
    wsx: torch.Tensor     # [n, D, D]
    wss: torch.Tensor     # [n, D, D]
    bs: torch.Tensor      # [n, D]
    # the matrices above as the kernels read them: [out, in] (K-major), in
    # tile order (tile_weights), with P = 2 (f32: the TF32 part, then the
    # rest) or 1 (bf16)
    pqkv_s: torch.Tensor  # [L, P, 3D * D]
    pwo_s: torch.Tensor   # [L, P, D * D]
    pqkv_x: torch.Tensor  # [L, P, 3D * D]
    pwo_x: torch.Tensor   # [L, P, D * D]
    pw1: torch.Tensor     # [L, P, F * D]
    pw2: torch.Tensor     # [L, P, D * F]
    pws: torch.Tensor     # [n, P, D * 2D]: [Wsx; Wss] transposed


_MATRICES = ("wqkv_s", "wo_s", "wqkv_x", "wo_x", "w1", "w2", "wsx", "wss")
_PACKED = ("pqkv_s", "pwo_s", "pqkv_x", "pwo_x", "pw1", "pw2", "pws")
# the C entry's weight arguments, in its order
_KERNEL_FIELDS = ("pqkv_s", "bqkv_s", "pwo_s", "bo_s", "pqkv_x", "bqkv_x",
                  "pwo_x", "bo_x", "ln1s", "ln1b", "ln2s", "ln2b", "ln3s",
                  "ln3b", "pw1", "b1", "pw2", "b2", "pws", "bs")


def can_fuse_decode(model_cfg) -> bool:
    """The fused decode applies to the MLD VAE's encoder_decoder arch,
    post-norm, learned PE, at most 8 latent tokens (``can_fuse_decode``,
    ``fused_seq_decoder.py:167-175``), read from the config's model
    section."""
    m = model_cfg
    return (bool(m.vae) and m.vae_type == "mld"
            and m.vae_arch == "encoder_decoder"
            and not m.normalize_before
            and m.position_embedding in ("v3", "learned")
            and m.latent_size <= MAX_M)


@torch.no_grad()
def stack_skip_decoder(decoder, weight_dtype=torch.float32
                       ) -> StackedSkipDecoder:
    """ops.transformer.SkipTransformerDecoder -> StackedSkipDecoder, on the
    decoder's device. Matrices in `weight_dtype`, vectors in f32."""
    layers = [*decoder.input_blocks, decoder.middle_block,
              *decoder.output_blocks]
    D = decoder.norm.normalized_shape[0]

    def mat(ws):
        return stack_matrices(ws, weight_dtype)

    vec = stack_vectors
    wsx, wss, bs = stack_skip_linears(list(decoder.linear_blocks), D,
                                      decoder.norm.weight.device,
                                      weight_dtype)
    mats = dict(
        wqkv_s=mat(l.self_attn.in_proj_weight for l in layers),
        wo_s=mat(l.self_attn.out_proj.weight for l in layers),
        wqkv_x=mat(l.multihead_attn.in_proj_weight for l in layers),
        wo_x=mat(l.multihead_attn.out_proj.weight for l in layers),
        w1=mat(l.linear1.weight for l in layers),
        w2=mat(l.linear2.weight for l in layers),
        wsx=wsx, wss=wss)
    return StackedSkipDecoder(
        bqkv_s=vec(l.self_attn.in_proj_bias for l in layers),
        bo_s=vec(l.self_attn.out_proj.bias for l in layers),
        bqkv_x=vec(l.multihead_attn.in_proj_bias for l in layers),
        bo_x=vec(l.multihead_attn.out_proj.bias for l in layers),
        ln1s=vec(l.norm1.weight for l in layers),
        ln1b=vec(l.norm1.bias for l in layers),
        ln2s=vec(l.norm2.weight for l in layers),
        ln2b=vec(l.norm2.bias for l in layers),
        ln3s=vec(l.norm3.weight for l in layers),
        ln3b=vec(l.norm3.bias for l in layers),
        b1=vec(l.linear1.bias for l in layers),
        b2=vec(l.linear2.bias for l in layers),
        bs=bs, **mats, **pack_decoder_weights(mats))


def tf32_split(w: torch.Tensor):
    """f32 w -> (big, small), w == big + small exactly: big is w rounded to
    TF32 (10 mantissa bits; to nearest, ties away), as the kernels' split
    of their other operand rounds (``csrc/mma_sm90.cuh:split_tf32``)."""
    big = ((w.view(torch.int32) + 0x1000) & -8192).view(torch.float32)
    return big, w - big


def tile_weights(m: torch.Tensor) -> torch.Tensor:
    """[L, P, N, K] matrices -> [L, P, N * K] in the order the decoder's
    GEMM loads them: tiles of 64 rows x 128 bytes of K (row tiles outermost,
    then K), 8 KB each, one bulk copy apiece, each in wgmma's 128-byte
    swizzle: the 16-byte piece c of tile row r stored at piece c ^ (r % 8),
    which spreads the 8 rows the tensor cores read together over all the
    banks of shared memory. Widths that do not fill whole tiles, which the
    kernels refuse (``_check``), give an empty copy."""
    L, P, N, K = m.shape
    e = 16 // m.element_size()  # elements a 16-byte piece
    if N % 64 or K % (8 * e):
        return m.new_empty(L, P, 0)
    v = m.reshape(L, P, N // 64, 64, K // (8 * e), 8, e)
    v = v.permute(0, 1, 2, 4, 3, 5, 6)
    r = torch.arange(64, device=m.device)[:, None]
    c = torch.arange(8, device=m.device)[None, :]
    return v[:, :, :, :, r, c ^ (r % 8)].reshape(L, P, N * K).contiguous()


def pack_decoder_weights(mats: dict) -> dict:
    """The stacked ``[L, in, out]`` matrices -> the kernels' copies
    (``_PACKED``): transposed to ``[L, out, in]`` (the skip linear's two
    halves back into one ``[n, D, 2D]``, as torch holds it), f32 ones split
    into the TF32 part and the rest (``[L, 2, out, in]``; bf16 ``[L, 1, out,
    in]``), then tiled (``tile_weights``)."""
    def t(m):
        m = m.transpose(1, 2).contiguous()
        if m.dtype == torch.bfloat16:
            return tile_weights(m[:, None])
        return tile_weights(torch.stack(tf32_split(m), dim=1))
    return dict(pqkv_s=t(mats["wqkv_s"]), pwo_s=t(mats["wo_s"]),
                pqkv_x=t(mats["wqkv_x"]), pwo_x=t(mats["wo_x"]),
                pw1=t(mats["w1"]), pw2=t(mats["w2"]),
                pws=t(torch.cat([mats["wsx"], mats["wss"]], dim=1)))


def _attend(q, k, v, key_ok, H):
    """q [B, Sq, D] (pre-scaled), k/v [B, Sk, D], key_ok [B, Sk] bool or
    None -> [B, Sq, D]; f32 scores and softmax, -1e9 on masked keys."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    Dh = D // H
    s = torch.einsum("bqhd,bkhd->bhqk", q.reshape(B, Sq, H, Dh),
                     k.reshape(B, Sk, H, Dh))
    if key_ok is not None:
        s = s.masked_fill(~key_ok[:, None, None, :], NEG_INF)
    p = s.softmax(dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.reshape(B, Sk, H, Dh)).reshape(B, Sq, D)


def skip_decoder_stack_plain(tgt: torch.Tensor, mem: torch.Tensor,
                             valid: torch.Tensor, stacked: StackedSkipDecoder,
                             n_block: int, num_heads: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch. tgt [B, T, D] queries (PE
    applied), mem [B, M, D] latent tokens, valid [B, T] bool frame mask ->
    [B, T, D] in tgt's dtype, before the stack's final norm.

    Every query attends key 0 whatever the mask, which keeps padded query
    rows and empty sequences finite (``fused_seq_decoder.py:257-260``)."""
    st = stacked
    D = tgt.shape[-1]
    H = num_heads
    scale = 1.0 / math.sqrt(D // H)
    key_ok = valid.bool().clone()
    key_ok[:, 0] = True
    x = tgt.float()
    mem = mem.float()
    stack = []
    for l in range(2 * n_block + 1):
        if l > n_block:
            i = l - n_block - 1
            x = _mm(x, st.wsx[i]) + _mm(stack.pop(), st.wss[i]) + st.bs[i]
        q, k, v = (_mm(x, st.wqkv_s[l]) + st.bqkv_s[l]).split(D, dim=-1)
        attn = _attend(q * scale, k, v, key_ok, H)
        x = _layer_norm(x + _mm(attn, st.wo_s[l]) + st.bo_s[l],
                        st.ln1s[l], st.ln1b[l])
        wx, bx = st.wqkv_x[l], st.bqkv_x[l]
        qx = (_mm(x, wx[:, :D]) + bx[:D]) * scale
        km = _mm(mem, wx[:, D:2 * D]) + bx[D:2 * D]
        vm = _mm(mem, wx[:, 2 * D:]) + bx[2 * D:]
        cross = _attend(qx, km, vm, None, H)
        x = _layer_norm(x + _mm(cross, st.wo_x[l]) + st.bo_x[l],
                        st.ln2s[l], st.ln2b[l])
        ff = F.gelu(_mm(x, st.w1[l]) + st.b1[l])
        x = _layer_norm(x + _mm(ff, st.w2[l]) + st.b2[l],
                        st.ln3s[l], st.ln3b[l])
        if l < n_block:
            stack.append(x)
    return x.to(tgt.dtype)


def launch_count(n_block: int, M: int) -> int:
    """Kernels the design launches per call, which the CUDA entry's own
    count (KERNELS) must equal: the self-attention's key mask once; per
    layer the QKV GEMM, the self-attention (K3), the out-projection with
    LN1, and the FFN's two GEMMs (the second with LN3); the cross-attention
    adds two one-row-a-sequence GEMMs at M=1 (its LN2 rides on LN1's
    epilogue) and four kernels otherwise (q, K/V, attention, out-projection
    with LN2); one skip GEMM per output block."""
    L = 2 * n_block + 1
    return 1 + L * (5 + (2 if M == 1 else 4)) + n_block


def _align(n: int) -> int:
    return -(-n // 256) * 256


def workspace_bytes(B: int, T: int, M: int, D: int, F_: int, n_block: int,
                    weight_bf16: bool) -> int:
    """Scratch the CUDA entry needs, each buffer 256-byte aligned
    (csrc/skip_decoder.cu:layout): two f32 activation buffers, the skip
    stack, the f32 attention output, the buffer of QKV (f32) and the FFN
    hidden layer, the memory's K/V, the per-sequence cross-attention
    output and the key mask (bytes). The skip stack and the FFN hidden
    layer take the weight dtype: they are only operands of products."""
    R = B * T
    es = 2 if weight_bf16 else 4
    return (3 * _align(R * D * 4) + _align(n_block * R * D * es)
            + _align(R * max(3 * D * 4, F_ * es)) + _align(B * M * 2 * D * 4)
            + _align(B * D * 4) + _align(R))


def _check(tgt, mem, valid, st: StackedSkipDecoder, n_block: int,
           num_heads: int):
    for name, t in (("tgt", tgt), ("mem", mem)):
        if t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 [B, S, D], got "
                             f"{t.dtype} {tuple(t.shape)}")
    B, T, D = tgt.shape
    M = mem.shape[1]
    if mem.shape[0] != B or mem.shape[2] != D or not 1 <= M <= MAX_M:
        raise ValueError(f"mem must be [B={B}, M<={MAX_M}, D={D}], got "
                         f"{tuple(mem.shape)}")
    if (valid.dtype != torch.int32 or tuple(valid.shape) != (B, T)
            or not valid.is_contiguous() or valid.device != tgt.device):
        raise ValueError(f"valid must be contiguous int32 [{B}, {T}] on "
                         f"{tgt.device}, got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if mem.device != tgt.device:
        raise ValueError("tgt and mem must be on one device")
    L = 2 * n_block + 1
    F_ = st.w1.shape[-1]
    if (D % num_heads or D % WIDTH_STEP or D > MAX_D or F_ % WIDTH_STEP
            or D // num_heads > MAX_DH or (D // num_heads) % 4):
        raise ValueError(f"unsupported widths D={D} H={num_heads} F={F_}: "
                         f"the kernels take D a multiple of {WIDTH_STEP} up "
                         f"to {MAX_D}, F a multiple of {WIDTH_STEP} and a "
                         f"head width that is a multiple of 4 up to "
                         f"{MAX_DH}")
    D3 = 3 * D
    shapes = {"wqkv_s": (L, D, D3), "bqkv_s": (L, D3), "wo_s": (L, D, D),
              "bo_s": (L, D), "wqkv_x": (L, D, D3), "bqkv_x": (L, D3),
              "wo_x": (L, D, D), "bo_x": (L, D),
              "ln1s": (L, D), "ln1b": (L, D), "ln2s": (L, D),
              "ln2b": (L, D), "ln3s": (L, D), "ln3b": (L, D),
              "w1": (L, D, F_), "b1": (L, F_), "w2": (L, F_, D), "b2": (L, D),
              "wsx": (n_block, D, D), "wss": (n_block, D, D),
              "bs": (n_block, D)}
    wdt = st.wqkv_s.dtype
    P = 1 if wdt == torch.bfloat16 else 2
    shapes.update({"pqkv_s": (L, P, D3 * D), "pwo_s": (L, P, D * D),
                   "pqkv_x": (L, P, D3 * D), "pwo_x": (L, P, D * D),
                   "pw1": (L, P, F_ * D), "pw2": (L, P, D * F_),
                   "pws": (n_block, P, 2 * D * D)})
    if wdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weights must be f32 or bf16, got {wdt}")
    for name, shape in shapes.items():
        t = getattr(st, name)
        want = wdt if name in _MATRICES + _PACKED else torch.float32
        if (tuple(t.shape) != shape or t.dtype != want
                or t.device != tgt.device or not t.is_contiguous()):
            raise ValueError(
                f"stacked.{name}: want contiguous {want} {shape} on "
                f"{tgt.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def skip_decoder_stack(tgt: torch.Tensor, mem: torch.Tensor,
                       valid: torch.Tensor, stacked: StackedSkipDecoder,
                       n_block: int, num_heads: int) -> torch.Tensor:
    """tgt [B, T, D] f32, mem [B, M, D] f32, valid [B, T] bool -> [B, T, D],
    the whole decoder stack before its final norm.

    CPU tensors take the plain version; CUDA tensors launch the kernels on
    the current stream (no synchronisation) or raise, also when autograd
    tracks an input (the kernels have no backward)."""
    global LAUNCHES, KERNELS
    if tgt.device.type == "cpu":
        return skip_decoder_stack_plain(tgt, mem, valid, stacked, n_block,
                                        num_heads)
    _build.check_no_grad("skip-decoder", tgt, mem, *stacked)
    if tgt.device.type != "cuda":
        raise ValueError(f"no skip-decoder kernel for device {tgt.device}")
    valid = valid.to(torch.int32).contiguous()
    _check(tgt, mem, valid, stacked, n_block, num_heads)
    B, T, D = tgt.shape
    M = mem.shape[1]
    F_ = stacked.w1.shape[-1]
    bf16 = stacked.wqkv_s.dtype == torch.bfloat16
    n_ws = workspace_bytes(B, T, M, D, F_, n_block, bf16)
    ws = torch.empty(n_ws, dtype=torch.uint8, device=tgt.device)
    out = torch.empty_like(tgt)
    lib = _build.library()
    launched = ctypes.c_int(0)
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        err = lib.mld_skip_decoder_forward(
            tgt.data_ptr(), mem.data_ptr(), valid.data_ptr(), out.data_ptr(),
            *(getattr(stacked, f).data_ptr() for f in _KERNEL_FIELDS),
            ws.data_ptr(), n_ws, B, T, M, D, num_heads, F_, n_block,
            int(bf16), ctypes.byref(launched), stream)
    if err != 0:
        raise RuntimeError(f"skip-decoder kernels failed to launch: "
                           f"cudaError {err}")
    LAUNCHES += 1
    KERNELS += launched.value
    work.add("skip_decoder", work.decoder_plain_flops(B, T, M, D, F_,
                                                      n_block))
    return out


@torch.no_grad()
def fused_vae_decode(vae, z: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """Serving-path MldVae.decode (``fused_vae_decode``,
    ``fused_seq_decoder.py:178-201``): learned-PE queries pe[:T] -> the
    decoder stack (kernel) -> final LayerNorm at eps 1e-5 -> final_layer ->
    zero outside the mask. z [B, M, D], mask [B, T] bool -> [B, T, nfeats]
    in z's dtype. The stack takes f32 activations: a bf16 z (a
    mixed-precision step's validation, on bf16 copies of the parameters)
    enters it in f32 with the matrices of those copies in bf16, K5's
    bf16-weight arm."""
    B, T = mask.shape
    D = z.shape[-1]
    queries = vae.query_pos_decoder.pe[:T, 0][None].expand(B, T, D)
    dec = vae.decoder
    h = skip_decoder_stack(queries.float().contiguous(),
                           z.float().contiguous(), mask, vae.stacked_decoder(),
                           len(dec.input_blocks), dec.num_heads)
    # the final norm at the kernel's eps (1e-5), as JAX's fused_vae_decode
    # (l.197)
    h = _layer_norm(h, dec.norm.weight, dec.norm.bias)
    return vae.final_layer(h.to(z.dtype)) * mask[..., None]
