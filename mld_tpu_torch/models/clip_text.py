"""Frozen CLIP text tower + host-side tokenizer (port of
``mld_tpu/models/clip_text.py``).

Module names are HuggingFace's ``CLIPTextModelWithProjection``
(``text_model.embeddings.token_embedding``, ``text_model.encoder.layers.N.
self_attn.q_proj``, ``...mlp.fc1``, ``text_model.final_layer_norm``,
``text_projection``), so an HF CLIP state_dict loads as it is:
``load_hf_clip_weights`` reads a local HF clone's weights (the drill's
hydration, ``scripts/parity_drill.py``), as the JAX package's does.

The tower computes in ``compute_dtype`` (bf16 in the serving preset) while its
output is f32; softmax and LayerNorm statistics are f32. Its parameters are
f32, or their bf16 copies under bf16 mixed-precision training
(``train/steps.py``), where the final LayerNorm and projection compute in f32
on the bf16 weights, as the JAX package's do. Each layer's causal attention is ``ops.attention.sdpa_flash_causal``: the
CUDA kernel K4 on the card, its plain version on the CPU. ``ClipTokenizer`` is a carried copy of the JAX package's (crc32 fallback
and EOT buckets), held equal by a test.
"""
from __future__ import annotations

import os
import re
import zlib
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mld_tpu_torch.ops.attention import sdpa_flash_causal
from mld_tpu_torch.ops.transformer import LayerNorm, Linear
from mld_tpu_torch.utils import trace
from mld_tpu_torch.utils.precision import linear

CLIP_VOCAB = 49408
CLIP_BOS = 49406
CLIP_EOS = 49407
CLIP_CONTEXT = 77


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _linear(x, layer: nn.Linear):
    # f32 params, activations in the compute dtype; an f32 tower's GEMMs at
    # the matmul precision in force
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return linear(x, layer.weight.to(x.dtype), b)


def _layer_norm(x, ln: nn.LayerNorm):
    # statistics in f32, output in the compute dtype
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


class ClipAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        B, S, D = x.shape
        H = self.heads
        Dh = D // H

        def split(t):
            return t.reshape(B, S, H, Dh).transpose(1, 2)

        q = split(_linear(x, self.q_proj) * (Dh ** -0.5))
        k = split(_linear(x, self.k_proj))
        v = split(_linear(x, self.v_proj))
        # q is already scaled: the kernel's sm_scale is 1
        out = sdpa_flash_causal(q.contiguous(), k.contiguous(),
                                v.contiguous(), 1.0)
        out = out.transpose(1, 2).reshape(B, S, D)
        return _linear(out, self.out_proj)


class ClipMLP(nn.Module):
    def __init__(self, width: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(width, intermediate)
        self.fc2 = nn.Linear(intermediate, width)

    def forward(self, x):
        return _linear(quick_gelu(_linear(x, self.fc1)), self.fc2)


class ClipEncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, intermediate: int):
        super().__init__()
        self.self_attn = ClipAttention(width, heads)
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = ClipMLP(width, intermediate)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x):
        x = x + self.self_attn(_layer_norm(x, self.layer_norm1))
        return x + self.mlp(_layer_norm(x, self.layer_norm2))


class ClipEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, width: int, context_length: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.position_embedding = nn.Embedding(context_length, width)


class ClipEncoder(nn.Module):
    def __init__(self, width, layers, heads, intermediate):
        super().__init__()
        self.layers = nn.ModuleList(
            ClipEncoderLayer(width, heads, intermediate)
            for _ in range(layers))


class ClipTextTransformer(nn.Module):
    def __init__(self, vocab_size, width, layers, heads, context_length,
                 intermediate):
        super().__init__()
        self.embeddings = ClipEmbeddings(vocab_size, width, context_length)
        self.encoder = ClipEncoder(width, layers, heads, intermediate)
        self.final_layer_norm = LayerNorm(width, eps=1e-5)


class ClipTextModel(nn.Module):
    """CLIP text transformer (ViT-L/14 text tower by default)."""

    def __init__(self, vocab_size: int = CLIP_VOCAB, width: int = 768,
                 layers: int = 12, heads: int = 12,
                 context_length: int = CLIP_CONTEXT,
                 projection_dim: int = 768, intermediate_size: int = 0,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.text_model = ClipTextTransformer(
            vocab_size, width, layers, heads, context_length,
            intermediate_size or 4 * width)
        self.text_projection = Linear(width, projection_dim, bias=False)
        self.compute_dtype = getattr(torch, compute_dtype)

    def forward(self, input_ids: torch.Tensor, mode: str = "pooled"):
        """input_ids [B, S] int. mode: "pooled" | "hidden" | "features".

        "features" = pooled @ text_projection (HF get_text_features);
        "pooled"   = EOS-position hidden state after the final LN;
        "hidden"   = full last_hidden_state."""
        tm = self.text_model
        B, S = input_ids.shape
        emb = tm.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[:S]
        x = x.to(self.compute_dtype)
        for layer in tm.encoder.layers:
            x = layer(x)
        x = tm.final_layer_norm(x.float())
        if mode == "hidden":
            return x
        # EOS position = argmax of ids (EOS is the largest vocab id)
        eos_idx = input_ids.argmax(dim=-1)
        pooled = x[torch.arange(B, device=x.device), eos_idx]
        if mode == "pooled":
            return pooled
        return self.text_projection(pooled)


# ------------------------------------------------------------------ weights
HF_CLIP_FILES = ("model.safetensors", "pytorch_model.bin")
# what an HF CLIPModel holds beside the text tower, and the position-id
# buffer HF keeps in the tower's embeddings
_NOT_TOWER = ("vision_model.", "visual_projection.", "logit_scale",
              "text_model.embeddings.position_ids")


def hf_text_tower_state(state) -> dict:
    """An HF CLIPModel / CLIPTextModel(WithProjection) state dict -> the
    tower's, in ``ClipTextModel``'s names: a leading ``model.`` stripped
    (``convert_hf_clip_text`` strips ``model.text_model.``,
    ``mld_tpu/models/clip_text.py:171-173``), the vision tower, its
    projection, ``logit_scale`` and the ``position_ids`` buffer dropped."""
    out = {}
    for key, val in state.items():
        k = key[len("model."):] if key.startswith("model.") else key
        if not k.startswith(_NOT_TOWER):
            out[k] = val
    return out


def load_hf_clip_weights(modelpath: str,
                         tower: Optional[nn.Module] = None) -> dict:
    """The text tower's state dict from a local HF CLIP clone's
    ``model.safetensors`` (read by ``utils/safetensors.py``) or
    ``pytorch_model.bin`` (weights only), loaded strictly into `tower` when
    one is given. Raises when the clone has neither file or no text-tower
    weights: the raising variant of the JAX package's loader
    (``mld_tpu/models/clip_text.py:275-295``), for where a silent random
    tower would invalidate the result."""
    for name in HF_CLIP_FILES:
        path = os.path.join(modelpath, name)
        if not os.path.exists(path):
            continue
        if name.endswith(".bin"):
            raw = torch.load(path, map_location="cpu", weights_only=True)
        else:
            from mld_tpu_torch.utils.safetensors import load_file
            raw = load_file(path)
        state = hf_text_tower_state(raw)
        if "text_model.embeddings.token_embedding.weight" not in state:
            raise ValueError(f"{path} has no CLIP text-tower weights")
        if tower is not None:
            tower.load_state_dict(state, strict=True)
        return state
    raise FileNotFoundError(f"no {' / '.join(HF_CLIP_FILES)} under "
                            f"{modelpath}")


# ------------------------------------------------------------------ tokenizer
class ClipTokenizer:
    """Host-side tokenizer. Uses the HF tokenizer when a local CLIP clone is
    available; otherwise a deterministic hash fallback (self-consistent for
    from-scratch training, NOT compatible with pretrained CLIP weights).

    The fallback hashes with zlib.crc32, NOT Python's built-in ``hash``:
    str hashing is salted per interpreter (PYTHONHASHSEED), so builtin-hash
    ids silently change between processes — a model trained in one process
    (train.py) would receive scrambled token ids in another (test.py /
    demo.py / study subprocesses), collapsing text conditioning to chance.
    This exact failure invalidated the first r5 precision study (every
    subprocess arm re-rolled the vocabulary). Same pitfall + fix as
    data/word_vectorizer.py's POS one-hot path."""

    def __init__(self, modelpath: Optional[str] = None,
                 context_length: int = CLIP_CONTEXT):
        self.context_length = context_length
        self._hf = None
        if modelpath and os.path.exists(modelpath):
            try:
                from transformers import AutoTokenizer
                self._hf = AutoTokenizer.from_pretrained(modelpath)
            except Exception:
                self._hf = None
        self._word_re = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")

    @property
    def is_exact(self) -> bool:
        return self._hf is not None

    def __call__(self, texts: List[str],
                 buckets: Optional[tuple] = None) -> np.ndarray:
        """-> int32 [B, L], padded (HF pads with EOS for CLIP).

        L is `context_length` (77) by default. With `buckets`, L is the
        smallest bucket that still contains every row's EOT token: under
        causal attention + EOT pooling the trailing pad columns are inert
        (masked to exp(-1e9)=0 in f32 softmax), so cropping is EXACT for
        the pooled/"features" modes while cutting the tower's FLOPs by
        L/77 (attention by (L/77)^2) — the measured serving bottleneck
        (docs/ROOFLINE.md:31-39). Do NOT use buckets for "hidden" mode:
        there the denoiser conditions on all 77 hidden states.
        """
        with trace.span("tokenize"):
            if self._hf is not None:
                enc = self._hf(texts, padding="max_length", truncation=True,
                               max_length=self.context_length,
                               return_tensors="np")
                out = enc["input_ids"].astype(np.int32)
            else:
                out = np.full((len(texts), self.context_length), CLIP_EOS,
                              np.int32)
                for i, text in enumerate(texts):
                    words = self._word_re.findall(
                        text.lower())[: self.context_length - 2]
                    ids = [CLIP_BOS] + [
                        (zlib.crc32(w.encode("utf-8")) % (CLIP_BOS - 1)) + 1
                        for w in words] + [CLIP_EOS]
                    out[i, : len(ids)] = ids
            if buckets:
                # EOS is the largest vocab id and pad == EOS, so argmax
                # finds the first EOS = the EOT position (same rule the
                # pooling uses)
                eot_max = int(out.argmax(axis=-1).max())
                L = next((b for b in sorted(buckets) if b > eot_max),
                         self.context_length)
                out = out[:, :L]
            return out
