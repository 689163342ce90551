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
f32 ``[L, K]``. LayerNorm eps is 1e-5 in every norm, as in the TPU kernel;
the plain module path (``MldVae.decode``) keeps flax's 1e-6, so the two
decode paths differ by design (ROADMAP.md section 3).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .attention import NEG_INF
from .fused_layer import (_layer_norm, _mm, stack_matrices,
                          stack_skip_linears, stack_vectors)

MAX_M = 8        # latent tokens the kernel takes (can_fuse_decode)
MAX_D = 256      # one GEMM block holds a whole row for the LayerNorm epilogue
MAX_DH = 64

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


_MATRICES = ("wqkv_s", "wo_s", "wqkv_x", "wo_x", "w1", "w2", "wsx", "wss")


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
    return StackedSkipDecoder(
        wqkv_s=mat(l.self_attn.in_proj_weight for l in layers),
        bqkv_s=vec(l.self_attn.in_proj_bias for l in layers),
        wo_s=mat(l.self_attn.out_proj.weight for l in layers),
        bo_s=vec(l.self_attn.out_proj.bias for l in layers),
        wqkv_x=mat(l.multihead_attn.in_proj_weight for l in layers),
        bqkv_x=vec(l.multihead_attn.in_proj_bias for l in layers),
        wo_x=mat(l.multihead_attn.out_proj.weight for l in layers),
        bo_x=vec(l.multihead_attn.out_proj.bias for l in layers),
        ln1s=vec(l.norm1.weight for l in layers),
        ln1b=vec(l.norm1.bias for l in layers),
        ln2s=vec(l.norm2.weight for l in layers),
        ln2b=vec(l.norm2.bias for l in layers),
        ln3s=vec(l.norm3.weight for l in layers),
        ln3b=vec(l.norm3.bias for l in layers),
        w1=mat(l.linear1.weight for l in layers),
        b1=vec(l.linear1.bias for l in layers),
        w2=mat(l.linear2.weight for l in layers),
        b2=vec(l.linear2.bias for l in layers),
        wsx=wsx, wss=wss, bs=bs)


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
    count (KERNELS) must equal: per layer the QKV GEMM, self-attention,
    out-projection (+LN1), the cross-attention (3 kernels at M=1, 4
    otherwise), FFN in and out (+LN3); one skip GEMM per output block."""
    L = 2 * n_block + 1
    return L * (5 + (3 if M == 1 else 4)) + n_block


def workspace_floats(B: int, T: int, M: int, D: int, F_: int,
                     n_block: int) -> int:
    """f32 scratch the CUDA entry needs: two activation buffers, the skip
    stack, the attention output, the QKV / FFN-hidden buffer, the memory's
    K/V and the per-sequence cross-attention output (csrc/skip_decoder.cu)."""
    R = B * T
    return (R * D * (3 + n_block) + R * max(3 * D, F_)
            + B * M * 2 * D + B * D)


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
    if (D % num_heads or D % 16 or D > MAX_D or F_ % 16
            or D // num_heads > MAX_DH or (D // num_heads) % 4):
        raise ValueError(f"unsupported widths D={D} H={num_heads} F={F_}: "
                         f"the kernels take D a multiple of 16 up to "
                         f"{MAX_D}, F a multiple of 16 and a head width "
                         f"that is a multiple of 4 up to {MAX_DH}")
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
    if wdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weights must be f32 or bf16, got {wdt}")
    for name, shape in shapes.items():
        t = getattr(st, name)
        want = wdt if name in _MATRICES else torch.float32
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
    n_ws = workspace_floats(B, T, M, D, F_, n_block)
    ws = torch.empty(n_ws, dtype=torch.float32, device=tgt.device)
    out = torch.empty_like(tgt)
    lib = _build.library()
    st = stacked
    launched = ctypes.c_int(0)
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        err = lib.mld_skip_decoder_forward(
            tgt.data_ptr(), mem.data_ptr(), valid.data_ptr(), out.data_ptr(),
            *(getattr(st, f).data_ptr() for f in StackedSkipDecoder._fields),
            ws.data_ptr(), n_ws, B, T, M, D, num_heads, F_, n_block,
            int(st.wqkv_s.dtype == torch.bfloat16), ctypes.byref(launched),
            stream)
    if err != 0:
        raise RuntimeError(f"skip-decoder kernels failed to launch: "
                           f"cudaError {err}")
    LAUNCHES += 1
    KERNELS += launched.value
    return out


@torch.no_grad()
def fused_vae_decode(vae, z: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """Serving-path MldVae.decode (``fused_vae_decode``,
    ``fused_seq_decoder.py:178-201``): learned-PE queries pe[:T] -> the
    decoder stack (kernel) -> final LayerNorm at eps 1e-5 -> final_layer ->
    zero outside the mask. z [B, M, D], mask [B, T] bool -> [B, T, nfeats]."""
    B, T = mask.shape
    D = z.shape[-1]
    queries = vae.query_pos_decoder.pe[:T, 0][None].expand(B, T, D)
    dec = vae.decoder
    h = skip_decoder_stack(queries.to(z.dtype).contiguous(), z.contiguous(),
                           mask, vae.stacked_decoder(),
                           len(dec.input_blocks), dec.num_heads)
    # the final norm at the kernel's eps (1e-5), as JAX's fused_vae_decode
    # (l.197)
    h = _layer_norm(h, dec.norm.weight, dec.norm.bias)
    return vae.final_layer(h) * mask[..., None]
