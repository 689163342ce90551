"""The ST-GCN action classifier of the UESTC a2m metrics, frozen (port of
``mld_tpu/models/uestc_stgcn.py``).

Parity target: mld/models/architectures/uestc_stgcn.py:8-446: the SMPL graph
partitioned spatially, 10 st-gcn blocks (64 / 128 / 256 channels, stride-2
temporal downsamples), edge-importance weights, a global average pool and a
1x1 convolution head. Evaluation only: each BatchNorm is applied as the
affine map of its running statistics, as the JAX package folds it. The
convolutions are ``torch.nn.functional.conv2d`` in NCHW, the layout the
checkpoint's weights have. The weights are a dict of tensors under the JAX
package's keys (``utils/convert.py:stgcn_params_to_torch``);
``build_smpl_graph`` is a carried copy (numpy).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from mld_tpu_torch.models.smpl import SMPL_PARENTS
from mld_tpu_torch.utils.convert import stgcn_params_to_torch
from mld_tpu_torch.utils.precision import matmul_precision


# ----------------------------------------------------------------- graph
def build_smpl_graph(strategy: str = "spatial", num_node: int = 24,
                     parents=None, max_hop: int = 1) -> np.ndarray:
    parents = parents if parents is not None else SMPL_PARENTS
    edges = [(i, i) for i in range(num_node)] + [
        (j, parents[j]) for j in range(1, num_node)]
    A = np.zeros((num_node, num_node))
    for i, j in edges:
        A[j, i] = 1
        A[i, j] = 1
    hop_dis = np.full((num_node, num_node), np.inf)
    transfer = [np.linalg.matrix_power(A, d) for d in range(max_hop + 1)]
    arrive = np.stack(transfer) > 0
    for d in range(max_hop, -1, -1):
        hop_dis[arrive[d]] = d

    adjacency = np.zeros((num_node, num_node))
    for hop in range(max_hop + 1):
        adjacency[hop_dis == hop] = 1
    Dl = adjacency.sum(0)
    Dn = np.diag([1.0 / d if d > 0 else 0 for d in Dl])
    norm_adj = adjacency @ Dn

    center = 0
    if strategy == "uniform":
        return norm_adj[None]
    out = []
    for hop in range(max_hop + 1):
        a_root = np.zeros_like(norm_adj)
        a_close = np.zeros_like(norm_adj)
        a_further = np.zeros_like(norm_adj)
        for i in range(num_node):
            for j in range(num_node):
                if hop_dis[j, i] == hop:
                    if hop_dis[j, center] == hop_dis[i, center]:
                        a_root[j, i] = norm_adj[j, i]
                    elif hop_dis[j, center] > hop_dis[i, center]:
                        a_close[j, i] = norm_adj[j, i]
                    else:
                        a_further[j, i] = norm_adj[j, i]
        if hop == 0:
            out.append(a_root)
        else:
            out.append(a_root + a_close)
            out.append(a_further)
    return np.stack(out)


# ------------------------------------------------------------ functional net
def _conv2d(x, p, stride=(1, 1), padding=(0, 0)):
    """torch-layout conv: x [N, C, H, W], p["weight"] [O, I, kh, kw]."""
    return F.conv2d(x, p["weight"], p["bias"], stride=stride,
                    padding=padding)


def _bn(x, p, axis=1):
    """BatchNorm from its frozen running statistics."""
    shape = [1] * x.ndim
    shape[axis] = -1
    inv = 1.0 / torch.sqrt(p["running_var"] + 1e-5)
    return ((x - p["running_mean"].reshape(shape)) * inv.reshape(shape)
            * p["weight"].reshape(shape) + p["bias"].reshape(shape))


_CHANNELS = [(6, 64, 1, False), (64, 64, 1, True), (64, 64, 1, True),
             (64, 64, 1, True), (64, 128, 2, True), (128, 128, 1, True),
             (128, 128, 1, True), (128, 256, 2, True), (256, 256, 1, True),
             (256, 256, 1, True)]


class STGCN:
    """The frozen ST-GCN on `device`. Weights from
    `convert_stgcn_checkpoint` or `init_random`, or a JAX-package param
    dict."""

    def __init__(self, params: Dict, num_class: int = 40,
                 in_channels: int = 6, strategy: str = "spatial",
                 device="cpu"):
        self.device = torch.device(device)
        self.params = stgcn_params_to_torch(params, self.device)
        self.num_class = num_class
        self.A = torch.as_tensor(build_smpl_graph(strategy),
                                 dtype=torch.float32, device=self.device)

    def _forward(self, motion: torch.Tensor):
        p = self.params
        x = motion.permute(0, 2, 3, 1)               # [N, C, T, V]
        N, C, T, V = x.shape
        # data_bn over the (V * C) flattened channels
        xb = x.permute(0, 3, 1, 2).reshape(N, V * C, T)
        xb = _bn(xb, p["data_bn"], axis=1)
        x = xb.reshape(N, V, C, T).permute(0, 2, 3, 1)

        K = self.A.shape[0]
        for i, (cin, cout, stride, residual) in enumerate(_CHANNELS):
            blk = p[f"st_gcn_networks_{i}"]
            A = self.A * p["edge_importance"][i]
            # gcn: 1x1 conv to K * cout, then the graph product
            y = _conv2d(x, blk["gcn"]["conv"])
            n, kc, t, v = y.shape
            y = y.reshape(n, K, kc // K, t, v)
            y = torch.einsum("nkctv,kvw->nctw", y, A)
            # tcn: BN -> relu -> (9, 1) conv with the stride -> BN
            y2 = torch.relu(_bn(y, blk["tcn"]["bn1"], axis=1))
            y2 = _conv2d(y2, blk["tcn"]["conv"], stride=(stride, 1),
                         padding=(4, 0))
            y2 = _bn(y2, blk["tcn"]["bn2"], axis=1)
            if not residual:
                res = 0.0
            elif cin == cout and stride == 1:
                res = x
            else:
                res = _bn(_conv2d(x, blk["residual"]["conv"],
                                  stride=(stride, 1)),
                          blk["residual"]["bn"], axis=1)
            x = torch.relu(y2 + res)

        feats = x.mean(dim=(2, 3))                   # global average pool
        logits = _conv2d(feats[:, :, None, None], p["fcn"])[:, :, 0, 0]
        return feats, logits

    def __call__(self, motion) -> tuple:
        """motion [N, V=24, C=6, T] rot6d (the reference's input layout) ->
        (features [N, 256], logits [N, num_class]), f32 without TF32."""
        motion = torch.as_tensor(motion).to(self.device, torch.float32)
        with torch.no_grad(), matmul_precision("highest"):
            return self._forward(motion)

    # ------------------------------------------------------------- factories
    @classmethod
    def init_random(cls, num_class: int = 40, in_channels: int = 6,
                    seed: int = 0, device="cpu"):
        """Random weights from the JAX package's numpy draws (the same
        values for the same seed)."""
        rng = np.random.RandomState(seed)
        K = build_smpl_graph().shape[0]

        def conv_p(cin, cout, kh, kw):
            scale = 1.0 / np.sqrt(cin * kh * kw)
            return {"weight": rng.uniform(-scale, scale,
                                          (cout, cin, kh, kw)).astype(
                                              np.float32),
                    "bias": np.zeros(cout, np.float32)}

        def bn_p(c):
            return {"weight": np.ones(c, np.float32),
                    "bias": np.zeros(c, np.float32),
                    "running_mean": np.zeros(c, np.float32),
                    "running_var": np.ones(c, np.float32)}

        params: Dict = {"data_bn": bn_p(24 * in_channels),
                        "edge_importance": [np.ones((K, 24, 24), np.float32)
                                            for _ in _CHANNELS]}
        for i, (cin, cout, stride, residual) in enumerate(_CHANNELS):
            blk = {"gcn": {"conv": conv_p(cin, cout * K, 1, 1)},
                   "tcn": {"bn1": bn_p(cout), "conv": conv_p(cout, cout, 9, 1),
                           "bn2": bn_p(cout)}}
            if residual and (cin != cout or stride != 1):
                blk["residual"] = {"conv": conv_p(cin, cout, 1, 1),
                                   "bn": bn_p(cout)}
            params[f"st_gcn_networks_{i}"] = blk
        params["fcn"] = conv_p(256, num_class, 1, 1)
        return cls(params, num_class, in_channels, device=device)


def convert_stgcn_checkpoint(tar_path: str, num_class: int = 40,
                             device="cpu") -> STGCN:
    """uestc_rot6d_stgcn.tar (torch) -> STGCN."""
    state = torch.load(tar_path, map_location="cpu", weights_only=False)
    if "model" in state:
        state = state["model"]

    def npy(t):
        return t.detach().cpu().numpy().astype(np.float32)

    def bn_from(prefix):
        return {"weight": npy(state[f"{prefix}.weight"]),
                "bias": npy(state[f"{prefix}.bias"]),
                "running_mean": npy(state[f"{prefix}.running_mean"]),
                "running_var": npy(state[f"{prefix}.running_var"])}

    params: Dict = {"data_bn": bn_from("data_bn"), "edge_importance": []}
    for i, (cin, cout, stride, residual) in enumerate(_CHANNELS):
        pre = f"st_gcn_networks.{i}"
        blk = {
            "gcn": {"conv": {"weight": npy(state[f"{pre}.gcn.conv.weight"]),
                             "bias": npy(state[f"{pre}.gcn.conv.bias"])}},
            "tcn": {"bn1": bn_from(f"{pre}.tcn.0"),
                    "conv": {"weight": npy(state[f"{pre}.tcn.2.weight"]),
                             "bias": npy(state[f"{pre}.tcn.2.bias"])},
                    "bn2": bn_from(f"{pre}.tcn.3")},
        }
        if residual and (cin != cout or stride != 1):
            blk["residual"] = {
                "conv": {"weight": npy(state[f"{pre}.residual.0.weight"]),
                         "bias": npy(state[f"{pre}.residual.0.bias"])},
                "bn": bn_from(f"{pre}.residual.1")}
        params[f"st_gcn_networks_{i}"] = blk
        params["edge_importance"].append(npy(state[f"edge_importance.{i}"]))
    params["fcn"] = {"weight": npy(state["fcn.weight"]),
                     "bias": npy(state["fcn.bias"])}
    return STGCN(params, num_class, device=device)
