"""Monodepth2's pose networks and pose utilities (counterpart of
super_tpu/models/pose.py), NCHW.

``PoseCNN`` (stacked strided convolutions to mean-pooled 6-DoF deltas),
``PoseDecoder`` (a pose head on ResNet encoder features, one pyramid per
frame) and ``transformation_from_parameters``.  No tracking path calls
them; they serve self-supervised depth and pose training on new rigs.
The JAX package loads no pose checkpoint of the reference, so neither
does the port: :func:`load_flax_params` takes the flax models' parameter
trees (as numpy arrays) instead.

As in the JAX package, the decoder gives each input feature its own
squeeze convolution (``squeeze``, ``squeeze_1``, ...), where the
reference's decoder shares one.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

POSE_CNN_SPECS = ((16, 7), (32, 5), (64, 3), (128, 3), (256, 3), (256, 3),
                  (256, 3))


def _split(x, n: int):
    """Mean-pooled (B, 6 n, h, w) -> 0.01-scaled (axisangle, translation),
    each (B, n, 1, 3)."""
    out = 0.01 * x.mean(dim=(2, 3))
    out = out.reshape(-1, n, 1, 6)
    return out[..., :3], out[..., 3:]


class PoseCNN(nn.Module):
    """Stacked strided convolutions over ``num_input_frames`` stacked RGB
    images (B, 3 n, H, W) -> mean-pooled 6-DoF deltas."""

    def __init__(self, num_input_frames: int = 2):
        super().__init__()
        self.num_input_frames = num_input_frames
        self.convs = nn.ModuleDict()
        cin = 3 * num_input_frames
        for i, (c, k) in enumerate(POSE_CNN_SPECS):
            self.convs[f"conv{i}"] = nn.Conv2d(cin, c, k, stride=2,
                                               padding=k // 2)
            cin = c
        self.convs["pose_conv"] = nn.Conv2d(cin, 6 * (num_input_frames - 1),
                                            1)

    def forward(self, x):
        for i in range(len(POSE_CNN_SPECS)):
            x = F.relu(self.convs[f"conv{i}"](x))
        return _split(self.convs["pose_conv"](x), self.num_input_frames - 1)


class PoseDecoder(nn.Module):
    """Pose head on the last feature of each input pyramid (``num_ch_enc``:
    its channels, 512 for ResNet-18)."""

    def __init__(self, num_input_features: int = 2,
                 num_frames_to_predict_for: int = 1, num_ch_enc: int = 512):
        super().__init__()
        self.num_frames_to_predict_for = num_frames_to_predict_for
        self.convs = nn.ModuleDict()
        for i in range(num_input_features):
            self.convs[f"squeeze_{i}" if i else "squeeze"] = nn.Conv2d(
                num_ch_enc, 256, 1)
        self.convs["pose_0"] = nn.Conv2d(256 * num_input_features, 256, 3,
                                         padding=1)
        self.convs["pose_1"] = nn.Conv2d(256, 256, 3, padding=1)
        self.convs["pose_2"] = nn.Conv2d(256, 6 * num_frames_to_predict_for,
                                         1)

    def forward(self, input_features: Sequence[Sequence[torch.Tensor]]):
        x = torch.cat([F.relu(self.convs[f"squeeze_{i}" if i else "squeeze"](
            f[-1])) for i, f in enumerate(input_features)], dim=1)
        x = F.relu(self.convs["pose_0"](x))
        x = F.relu(self.convs["pose_1"](x))
        return _split(self.convs["pose_2"](x), self.num_frames_to_predict_for)


@torch.no_grad()
def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Copy a flax ``PoseCNN`` or ``PoseDecoder`` parameter tree (numpy
    leaves; with or without the outer ``"params"``) into ``module``:
    kernels HWIO -> OIHW.  Every convolution must be given, and no other."""
    params = params.get("params", params)
    if set(params) != set(module.convs):
        raise ValueError(f"parameter names {sorted(params)} are not the "
                         f"module's {sorted(module.convs)}")
    for name, conv in module.convs.items():
        kernel = np.asarray(params[name]["kernel"],
                            np.float32).transpose(3, 2, 0, 1)
        bias = np.array(params[name]["bias"], np.float32)
        if kernel.shape != conv.weight.shape or bias.shape != conv.bias.shape:
            raise ValueError(f"{name}: kernel {kernel.shape} bias "
                             f"{bias.shape}, want {tuple(conv.weight.shape)} "
                             f"{tuple(conv.bias.shape)}")
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel)))
        conv.bias.copy_(torch.from_numpy(bias))
    return module


def axisangle_to_matrix(vec):
    """Rodrigues rotation (..., 3) -> (..., 3, 3)."""
    angle = torch.linalg.norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., None]
    sa = torch.sin(angle)[..., None]
    c1 = 1 - ca
    x, y, z = (axis[..., i:i + 1, None] for i in range(3))
    return torch.cat([
        torch.cat([x * x * c1 + ca, x * y * c1 - z * sa,
                   z * x * c1 + y * sa], -1),
        torch.cat([x * y * c1 + z * sa, y * y * c1 + ca,
                   y * z * c1 - x * sa], -1),
        torch.cat([z * x * c1 - y * sa, y * z * c1 + x * sa,
                   z * z * c1 + ca], -1),
    ], dim=-2)


def transformation_from_parameters(axisangle, translation, invert=False):
    """(axisangle, translation) (..., 3) -> (..., 4, 4) transform; with
    ``invert`` the inverse rigid transform."""
    r = axisangle_to_matrix(axisangle)
    t = translation
    if invert:
        r = r.transpose(-1, -2)
        t = -torch.einsum("...ij,...j->...i", r, t)
    top = torch.cat([r, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)
