"""RAFT optical flow (RAFT-large) for the ``sf_corr`` loss, in the original
RAFT checkpoint's key layout (counterpart of super_tpu/models/raft_flow.py).

Shared-weight feature encoder ``fnet`` (instance norm) and context encoder
``cnet`` (batch norm) at 1/8, the 2-D all-pairs correlation pyramid (one
product of the feature maps), the separable ConvGRU refinement and convex
upsampling; ``update_block`` {encoder, gru, flow_head, mask}.  Within a
level the correlation window's x-offset is the outer channel axis, as in
RAFT (its meshgrid(dy, dx) feeds dy into the sampler's x slot).

:func:`torchvision_raft_keys` renames torchvision's ``raft_large`` layout,
the reference's weight source, onto this one: torchvision's RAFT is the
same network under other module names.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import torch
from torch import nn

from super_tpu_torch.models.raft_stereo import (
    BasicEncoder,
    FlowHead,
    _mask_head,
    convex_upsample,
)

CORR_LEVELS = 4
CORR_RADIUS = 4
HIDDEN = 128


def build_corr_pyramid_2d(fmap1, fmap2, num_levels: int = CORR_LEVELS):
    """(N, D, H, W) x 2 -> [(N, H, W, H / 2^l, W / 2^l)] (2x2 averages)."""
    n, d, h, w = fmap1.shape
    corr = torch.einsum("ndhw,nduv->nhwuv", fmap1, fmap2) / math.sqrt(d)
    pyr = [corr]
    for _ in range(num_levels - 1):
        u, v = corr.shape[-2:]
        corr = corr[..., :u // 2 * 2, :v // 2 * 2].reshape(
            n, h, w, u // 2, 2, v // 2, 2).mean((4, 6))
        pyr.append(corr)
    return pyr


def lookup_corr_2d(pyr, cx, cy, radius: int = CORR_RADIUS):
    """Bilinear (2r+1)^2 window of each level around (cx, cy) / 2^l, zero
    outside the volume: (N, levels * (2r+1)^2, H, W), the x-offset the
    outer axis within a level.  One gather of the (2r+2)^2 integer
    corners per level."""
    size = 2 * radius + 1
    k = torch.arange(size + 1, dtype=cx.dtype, device=cx.device)
    outs = []
    for lvl, corr in enumerate(pyr):
        n, h, w, u, v = corr.shape
        x = cx / (2 ** lvl) - radius
        y = cy / (2 ** lvl) - radius
        x0, y0 = torch.floor(x), torch.floor(y)
        ax = (x - x0)[..., None, None]
        ay = (y - y0)[..., None, None]
        rows = (y0[..., None] + k)[..., :, None]          # (N,H,W,S+1,1)
        cols = (x0[..., None] + k)[..., None, :]          # (N,H,W,1,S+1)
        inb = (rows >= 0) & (rows <= u - 1) & (cols >= 0) & (cols <= v - 1)
        idx = (torch.clamp(torch.nan_to_num(rows), 0, u - 1) * v
               + torch.clamp(torch.nan_to_num(cols), 0, v - 1)).long()
        g = torch.gather(corr.reshape(n, h, w, u * v), -1,
                         idx.reshape(n, h, w, -1)).reshape(idx.shape)
        g = torch.where(inb, g, 0.0)
        val = (g[..., :-1, :-1] * (1 - ay) * (1 - ax)
               + g[..., :-1, 1:] * (1 - ay) * ax
               + g[..., 1:, :-1] * ay * (1 - ax)
               + g[..., 1:, 1:] * ay * ax)                # (N,H,W,y,x)
        outs.append(val.transpose(-1, -2).reshape(n, h, w, size * size))
    return torch.cat(outs, dim=-1).permute(0, 3, 1, 2)


class SepConvGRU(nn.Module):
    """A 1x5 then a 5x1 GRU pass."""

    def __init__(self, hidden: int = HIDDEN, cin: int = 2 * HIDDEN):
        super().__init__()
        for tag, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for g in "zrq":
                setattr(self, f"conv{g}{tag}",
                        nn.Conv2d(hidden + cin, hidden, k, padding=pad))

    def forward(self, h, x):
        for tag in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{tag}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{tag}")(hx))
            q = torch.tanh(getattr(self, f"convq{tag}")(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class MotionEncoder2D(nn.Module):
    """RAFT-large's motion encoder (324-channel correlation window)."""

    def __init__(self):
        super().__init__()
        planes = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2
        self.convc1 = nn.Conv2d(planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 126, 3, padding=1)

    def forward(self, flow, corr):
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class _UpdateBlock(nn.Module):
    def __init__(self, factor: int = 8):
        super().__init__()
        self.encoder = MotionEncoder2D()
        self.gru = SepConvGRU()
        self.flow_head = FlowHead(HIDDEN)
        self.mask = _mask_head(HIDDEN, factor)

    def forward(self, net, inp, corr, flow, with_mask: bool = True):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        mask = 0.25 * self.mask(net) if with_mask else None
        return net, mask, self.flow_head(net)


class RAFTFlow(nn.Module):
    """Images (N, 3, H, W) in [0, 1] -> flow (N, 2, H, W) (u, v) from the
    first to the second.  Inference only."""

    def __init__(self, iters: int = 12, downsample: int = 3):
        super().__init__()
        self.iters = iters
        self.downsample = downsample
        self.fnet = BasicEncoder(256, "instance", downsample)
        self.cnet = BasicEncoder(256, "batch", downsample)
        self.update_block = _UpdateBlock(2 ** downsample)
        self.eval()

    def forward(self, image1, image2, iters: int | None = None):
        iters = self.iters if iters is None else iters
        x1 = 2.0 * image1 - 1.0
        x2 = 2.0 * image2 - 1.0
        b = image1.shape[0]
        f = self.fnet(torch.cat([x1, x2]))
        pyr = build_corr_pyramid_2d(f[:b], f[b:])
        c = self.cnet(x1)
        net = torch.tanh(c[:, :HIDDEN])
        inp = torch.relu(c[:, HIDDEN:])
        _, _, h, w = c.shape
        dev = image1.device
        gx = torch.arange(w, dtype=torch.float32, device=dev).expand(b, h, w)
        gy = torch.arange(h, dtype=torch.float32,
                          device=dev)[:, None].expand(b, h, w)
        fx = torch.zeros_like(gx)
        fy = torch.zeros_like(gy)
        mask = None
        for it in range(iters):
            corr = lookup_corr_2d(pyr, gx + fx, gy + fy)
            net, mask, delta = self.update_block(
                net, inp, corr, torch.stack([fx, fy], dim=1),
                with_mask=it == iters - 1)
            fx = fx + delta[:, 0]
            fy = fy + delta[:, 1]
        return convex_upsample(torch.stack([fx, fy], dim=1), mask,
                               2 ** self.downsample)


def _rename_encoder(nk: str) -> str:
    nk = nk.replace(".convnormrelu1.0.", ".conv1.")
    nk = nk.replace(".convnormrelu1.1.", ".norm1.")
    nk = nk.replace(".convnormrelu2.0.", ".conv2.")
    nk = nk.replace(".convnormrelu2.1.", ".norm2.")
    nk = re.sub(r"^(fnet|cnet)\.convnormrelu\.0\.", r"\1.conv1.", nk)
    nk = re.sub(r"^(fnet|cnet)\.convnormrelu\.1\.", r"\1.norm1.", nk)
    return re.sub(r"^(fnet|cnet)\.conv\.", r"\1.conv2.", nk)


_MOTION = {"corr1": "c1", "corr2": "c2", "flow1": "f1", "flow2": "f2"}


def torchvision_raft_keys(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """torchvision ``raft_large`` state dict -> :class:`RAFTFlow`'s keys.

    feature_encoder / context_encoder -> fnet / cnet, with
    convnormrelu.{0,1} -> conv1 / norm1, layerL.B.convnormrelu{1,2}.{0,1}
    -> conv1 / conv2 + norm1 / norm2, the final conv -> conv2, and each
    block's downsample norm under both of its names (downsample.1 and
    norm3); update_block.motion_encoder.conv{corr1,corr2,flow1,flow2,
    conv}.0 -> update_block.encoder.{convc1,convc2,convf1,convf2,conv};
    update_block.recurrent_block.convgru{1,2}.conv{z,r,q} ->
    update_block.gru.conv{z,r,q}{1,2}; mask_predictor.{convrelu.0,conv}
    -> update_block.mask.{0,2}.  Only raft_large's layout."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        nk = k.replace("feature_encoder.", "fnet.").replace(
            "context_encoder.", "cnet.")
        if nk.startswith(("fnet.", "cnet.")):
            nk = _rename_encoder(nk)
        nk = re.sub(
            r"^update_block\.motion_encoder\.conv(corr1|corr2|flow1|flow2)"
            r"\.0\.", lambda m: "update_block.encoder.conv%s." % _MOTION[
                m.group(1)], nk)
        nk = nk.replace("update_block.motion_encoder.conv.0.",
                        "update_block.encoder.conv.")
        nk = re.sub(r"^update_block\.recurrent_block\.convgru([12])"
                    r"\.conv([zrq])\.", r"update_block.gru.conv\g<2>\g<1>.",
                    nk)
        nk = nk.replace("mask_predictor.convrelu.0.", "update_block.mask.0.")
        nk = nk.replace("mask_predictor.conv.", "update_block.mask.2.")
        out[nk] = v
        if ".downsample.1." in nk:
            out[nk.replace(".downsample.1.", ".norm3.")] = v
    return out
