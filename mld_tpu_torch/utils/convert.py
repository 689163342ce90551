"""Flax param tree -> torch ``state_dict`` (the inverse of
``mld_tpu/utils/torch_convert.py:torch_state_dict_to_flax`` and of
``mld_tpu/models/clip_text.py:convert_hf_clip_text``).

Works on trees of numpy arrays, so the port loads weights produced by the
JAX package without importing it.

Rules for the denoiser and VAE subtrees:
  ``kernel`` [in, out]         -> ``weight`` [out, in]
  ``in_proj_kernel``           -> ``in_proj_weight`` (transposed)
  LayerNorm ``scale``          -> ``weight``
  ``input_blocks_0``           -> ``input_blocks.0`` (and output_blocks,
                                  linear_blocks, layers)
  ``emb_proj``                 -> ``emb_proj.1`` (Sequential(ReLU, Linear))
  ``emb_proj_action``          -> ``emb_proj`` (EmbedAction, the reference's
                                  ``emb_proj.action_embedding``)
  ``pe``, ``global_motion_token``, the ACTOR VAE's ``mu_token`` and
  ``logvar_token``, ``action_embedding`` and every other leaf pass
  unchanged; the ACTOR VAE's ``seqTransEncoder`` / ``seqTransDecoder`` and
  ``skel_embedding`` / ``final_layer`` follow the rules above, as do the
  options' modules: ``dist_layer`` (mlp_dist), the plain encoder's and the
  latent ``trans_dec``'s ``layers_N`` / ``norm`` / ``mem_pos``, raw
  motion's ``pose_embd`` / ``pose_proj``, and VPosert's Dense layers and
  BatchNorm ``scale`` / ``bias``. A VPosert's ``batch_stats`` collection
  (``mean`` / ``var``), when given, becomes its BatchNorms'
  ``running_mean`` / ``running_var``.

The inverse for a whole model, ``state_dict_to_flax``: an ``MLD``'s
state_dict -> ``{vae, denoiser, clip}`` as ``MLD.init_params`` lays the tree
out (the modules the model has), through ``module_state_to_flax`` (the
inverse of ``flax_to_state_dict``: ``weight`` of two or more axes ->
``kernel`` with its axes reversed, of one axis -> ``scale``; ``X.N`` ->
``X_N``; ``emb_proj.1`` -> ``emb_proj``, a bare ``emb_proj`` ->
``emb_proj_action``; running statistics -> a ``batch_stats`` collection)
and ``state_dict_to_flax_clip`` (the inverse of
``flax_clip_to_state_dict``). JAX's ``init_params`` keeps no
``batch_stats`` (``mld_tpu/models/mld.py:162``), so the model's tree holds
none either.

The t2m evaluator networks' trees (``flax_t2m_to_state_dict`` and its
inverse ``state_dict_to_flax_t2m``): ``kernel`` -> ``weight`` with its axes
reversed (Dense [in, out] -> [out, in]; Conv [k, in, out] -> Conv1d's
[out, in, k]), ``out/output_net_N`` -> ``output_net.N``, ``main_N`` ->
``main.N``, LayerNorm ``scale`` -> ``weight``; the GRU's torch-named leaves
and ``hidden`` [2, 1, H] pass unchanged.

The a2m classifiers: the HumanAct12 GRU's tree (``MotionDiscriminator``:
``recurrent/weight_ih_l{k}`` ... leaves, flat as flax holds them or nested as
an npz reads back, ``linear1`` / ``linear2`` Dense) and the UESTC ST-GCN's
param dict (numpy leaves under the JAX package's keys, kept as they are,
as tensors).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_INDEXED = re.compile(
    r"^(input_blocks|output_blocks|linear_blocks|layers)_(\d+)$")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _module_name(part: str) -> str:
    m = _INDEXED.match(part)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    if part == "emb_proj":
        return "emb_proj.1"
    if part == "emb_proj_action":
        return "emb_proj"
    return part


def flax_to_state_dict(tree: Mapping, batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    """A denoiser or VAE flax param tree -> torch state_dict; with
    `batch_stats`, a flax batch_stats collection, its BatchNorm statistics
    too."""
    out: Dict[str, torch.Tensor] = {}
    for module, stats in (batch_stats or {}).items():
        out[f"{module}.running_mean"] = _tensor(stats["mean"])
        out[f"{module}.running_var"] = _tensor(stats["var"])

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + [_module_name(key)])
                continue
            arr = np.asarray(val)
            if key == "kernel":
                key, arr = "weight", arr.T
            elif key == "in_proj_kernel":
                key, arr = "in_proj_weight", arr.T
            elif key == "scale":
                key = "weight"
            out[".".join(path + [key])] = _tensor(arr)

    walk(tree, [])
    return out


def flax_clip_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The CLIP text tower's flax param tree -> HF
    ``CLIPTextModelWithProjection`` state_dict names."""
    out = {
        "text_model.embeddings.token_embedding.weight":
            _tensor(tree["token_embedding"]),
        "text_model.embeddings.position_embedding.weight":
            _tensor(tree["position_embedding"]),
        "text_projection.weight": _tensor(np.asarray(tree["text_projection"]).T),
    }
    final = tree["final_layer_norm"]
    out["text_model.final_layer_norm.weight"] = _tensor(final["scale"])
    out["text_model.final_layer_norm.bias"] = _tensor(final["bias"])
    for name, layer in tree.items():
        m = re.match(r"^layers_(\d+)$", name)
        if not m:
            continue
        pre = f"text_model.encoder.layers.{m.group(1)}"
        for sub, p in layer.items():
            if sub == "self_attn":
                for proj, q in p.items():
                    out[f"{pre}.self_attn.{proj}.weight"] = _tensor(
                        np.asarray(q["kernel"]).T)
                    out[f"{pre}.self_attn.{proj}.bias"] = _tensor(q["bias"])
            elif sub in ("layer_norm1", "layer_norm2"):
                out[f"{pre}.{sub}.weight"] = _tensor(p["scale"])
                out[f"{pre}.{sub}.bias"] = _tensor(p["bias"])
            else:  # fc1, fc2
                out[f"{pre}.mlp.{sub}.weight"] = _tensor(np.asarray(p["kernel"]).T)
                out[f"{pre}.mlp.{sub}.bias"] = _tensor(p["bias"])
    return out


def _numpy(val) -> np.ndarray:
    arr = val.detach().cpu().numpy() if torch.is_tensor(val) else val
    return np.array(arr, order="C")


def _insert(tree: Dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _flax_path(mods) -> list:
    """Torch module names -> flax scopes (``_module_name`` inverted)."""
    out, i = [], 0
    while i < len(mods):
        name = mods[i]
        nxt = mods[i + 1] if i + 1 < len(mods) else None
        if name == "emb_proj" and nxt == "1":
            out.append("emb_proj")
            i += 2
            continue
        if name == "emb_proj":
            out.append("emb_proj_action")
        elif (nxt is not None and nxt.isdigit()
              and _INDEXED.match(f"{name}_{nxt}")):
            out.append(f"{name}_{nxt}")
            i += 1
        else:
            out.append(name)
        i += 1
    return out


def module_state_to_flax(state: Mapping) -> Tuple[Dict, Dict]:
    """A denoiser's or VAE's state_dict (names relative to the module) ->
    (its flax param tree, its batch_stats collection): the inverse of
    ``flax_to_state_dict``."""
    params: Dict = {}
    stats: Dict = {}
    for name, val in state.items():
        arr = _numpy(val)
        *mods, leaf = name.split(".")
        if leaf in ("running_mean", "running_var"):
            stats.setdefault(".".join(mods), {})[
                "mean" if leaf == "running_mean" else "var"] = arr
            continue
        if leaf == "weight":
            leaf, arr = (("kernel", np.array(arr.T, order="C"))
                         if arr.ndim >= 2 else ("scale", arr))
        elif leaf == "in_proj_weight":
            leaf, arr = "in_proj_kernel", np.array(arr.T, order="C")
        _insert(params, _flax_path(mods) + [leaf], arr)
    return params, stats


def state_dict_to_flax_clip(state: Mapping) -> Dict:
    """The CLIP text tower's state_dict (HF names) -> its flax tree: the
    inverse of ``flax_clip_to_state_dict``."""
    tree: Dict = {}
    for name, val in state.items():
        arr = _numpy(val)
        if name == "text_projection.weight":
            tree["text_projection"] = np.array(arr.T, order="C")
            continue
        parts = name.split(".")
        if parts[:2] == ["text_model", "embeddings"]:
            tree[parts[2]] = arr
            continue
        if parts[:2] == ["text_model", "final_layer_norm"]:
            _insert(tree, ["final_layer_norm", "scale" if parts[2] == "weight"
                           else "bias"], arr)
            continue
        if parts[:3] != ["text_model", "encoder", "layers"]:
            raise KeyError(f"not a CLIP text tower name: {name}")
        layer, sub, leaf = f"layers_{parts[3]}", parts[4:-1], parts[-1]
        if sub[0] == "mlp":          # mlp.fc1 -> fc1
            sub = sub[1:]
        if sub[0].startswith("layer_norm"):
            leaf = "scale" if leaf == "weight" else leaf
        elif leaf == "weight":
            leaf, arr = "kernel", np.array(arr.T, order="C")
        _insert(tree, [layer] + sub + [leaf], arr)
    return tree


def state_dict_to_flax(state: Mapping) -> Dict:
    """An ``MLD`` state_dict -> the JAX package's param tree ``{vae,
    denoiser, clip}`` of numpy arrays (the modules present), as
    ``MLD.init_params`` lays it out; running statistics are left out, as
    JAX's tree holds none."""
    by_top: Dict[str, Dict] = {}
    for name, val in state.items():
        top, rest = name.split(".", 1)
        if top not in ("vae", "denoiser", "clip"):
            raise KeyError(f"not an MLD module: {name}")
        by_top.setdefault(top, {})[rest] = val
    tree = {}
    for top, sub in by_top.items():
        tree[top] = (state_dict_to_flax_clip(sub) if top == "clip"
                     else module_state_to_flax(sub)[0])
    return tree


_T2M_SEQ = re.compile(r"^(main|output_net)_(\d+)$")


def flax_t2m_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """One t2m evaluator net's flax tree (the JAX bundle's "text", "move" or
    "motion") -> the torch module's state_dict (models/t2m_eval.py)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                m = _T2M_SEQ.match(key)
                # "out" is the OutputNet's own scope; torch has none
                walk(val, path if key == "out" else
                     path + [f"{m.group(1)}.{m.group(2)}" if m else key])
                continue
            arr = np.asarray(val)
            if key == "kernel":
                key, arr = "weight", arr.T
            elif key == "scale":
                key = "weight"
            out[".".join(path + [key])] = _tensor(arr)

    walk(tree, [])
    return out


def state_dict_to_flax_t2m(state: Mapping) -> Dict:
    """The inverse of flax_t2m_to_state_dict: a t2m evaluator module's
    state_dict -> the JAX package's tree of numpy arrays."""
    tree: Dict = {}
    for name, val in state.items():
        arr = val.detach().cpu().numpy() if torch.is_tensor(val) else val
        *mods, leaf = name.split(".")
        path, i = [], 0
        while i < len(mods):
            if mods[i] in ("main", "output_net"):
                path += (["out"] if mods[i] == "output_net" else []) + [
                    f"{mods[i]}_{mods[i + 1]}"]
                i += 2
            else:
                path.append(mods[i])
                i += 1
        if leaf == "weight":
            leaf, arr = ("kernel", arr.T) if arr.ndim >= 2 else ("scale", arr)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(arr, order="C")
    return tree


def flax_humanact12_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The HumanAct12 GRU classifier's flax tree -> the torch module's
    state_dict (``models/humanact12_gru.py``): ``recurrent/weight_ih_l0``
    -> ``recurrent.weight_ih_l0`` (torch's GRU layout already), Dense
    ``kernel`` [in, out] -> ``weight`` [out, in]."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping) and key == "recurrent":
            out.update({f"recurrent.{k}": _tensor(v) for k, v in val.items()})
        elif isinstance(val, Mapping):
            out[f"{key}.weight"] = _tensor(np.asarray(val["kernel"]).T)
            out[f"{key}.bias"] = _tensor(val["bias"])
        else:   # flax's flat "recurrent/<name>" leaf
            out[key.replace("/", ".")] = _tensor(val)
    return out


def state_dict_to_flax_humanact12(state: Mapping) -> Dict:
    """The inverse: the classifier's state_dict -> the JAX package's tree
    (flat ``recurrent/...`` leaves, Dense ``kernel`` / ``bias``) of numpy
    arrays."""
    tree: Dict = {}
    for name, val in state.items():
        arr = val.detach().cpu().numpy()
        mod, leaf = name.split(".", 1)
        if mod == "recurrent":
            tree[f"recurrent/{leaf}"] = arr
        else:
            tree.setdefault(mod, {})[
                "kernel" if leaf == "weight" else "bias"] = np.array(
                    arr.T if leaf == "weight" else arr, order="C")
    return tree


def stgcn_params_to_torch(tree, device="cpu"):
    """The ST-GCN's param dict (the JAX package's layout: ``data_bn``,
    ``st_gcn_networks_{i}`` / ``gcn`` / ``tcn`` / ``residual``, the list
    ``edge_importance``, ``fcn``) with every leaf as an f32 tensor on
    `device`."""
    if isinstance(tree, Mapping):
        return {k: stgcn_params_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [stgcn_params_to_torch(v, device) for v in tree]
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)
