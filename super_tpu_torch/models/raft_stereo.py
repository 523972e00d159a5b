"""RAFT-Stereo in the reference checkpoint's key layout (counterpart of
super_tpu/models/raft_stereo.py).

The reference's defaults: corr_levels 4, corr_radius 4, n_downsample 2,
three GRU levels of hidden width 128, context_norm "batch", the "reg"
correlation (no CUDA sampler), no shared backbone, no slow-fast GRU.
Modules and names follow the reference's raft_core: ``fnet`` (instance
norm, no norm parameters), ``cnet`` (batch norm on running statistics),
``context_zqr_convs`` and ``update_block`` {encoder, gru08/16/32,
flow_head, mask}.

The all-pairs 1-D correlation is one product of the feature maps, and the
radius lookup is a gather along the row with linear weights, zero outside
the volume (the reference's grid_sample with zero padding; the left edge
as the JAX package has it, see :func:`_window`).  The GRU
iterations are a Python loop; the upsampling mask is computed on the last
iteration only (it does not feed the recurrence).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

CORR_LEVELS = 4
CORR_RADIUS = 4
HIDDEN = 128


def _norm_layer(kind: str, c: int) -> nn.Module:
    if kind == "batch":
        return nn.BatchNorm2d(c)
    if kind == "instance":
        return nn.InstanceNorm2d(c)      # affine=False: no parameters
    raise ValueError(kind)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm_fn: str = "instance",
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm_layer(norm_fn, planes)
        self.norm2 = _norm_layer(norm_fn, planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            # One module under two names, as in the reference (its state
            # dict carries both ``norm3.*`` and ``downsample.1.*``).
            self.norm3 = _norm_layer(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


def _layer(cin, dim, norm_fn, stride):
    return nn.Sequential(ResidualBlock(cin, dim, norm_fn, stride),
                         ResidualBlock(dim, dim, norm_fn, 1))


class _Stem(nn.Module):
    """The shared trunk of both encoders: 7x7 conv, norm, three stages at
    1/2^downsample."""

    def __init__(self, norm_fn: str, downsample: int):
        super().__init__()
        d = downsample
        self.conv1 = nn.Conv2d(3, 64, 7, stride=1 + (d > 2), padding=3)
        self.norm1 = _norm_layer(norm_fn, 64)
        self.layer1 = _layer(64, 64, norm_fn, 1)
        self.layer2 = _layer(64, 96, norm_fn, 1 + (d > 1))
        self.layer3 = _layer(96, 128, norm_fn, 1 + (d > 0))

    def trunk(self, x):
        x = torch.relu(self.norm1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(x)))


class BasicEncoder(_Stem):
    """Feature encoder at 1/2^downsample resolution."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance",
                 downsample: int = 2):
        super().__init__(norm_fn, downsample)
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        return self.conv2(self.trunk(x))


class MultiBasicEncoder(_Stem):
    """Context encoder: (hidden, context) pairs at three scales."""

    def __init__(self, norm_fn: str = "batch", downsample: int = 2,
                 hidden: int = HIDDEN):
        super().__init__(norm_fn, downsample)
        self.layer4 = _layer(128, 128, norm_fn, 2)
        self.layer5 = _layer(128, 128, norm_fn, 2)
        for scale in ("08", "16"):
            setattr(self, f"outputs{scale}", nn.ModuleList([
                nn.Sequential(ResidualBlock(128, 128, norm_fn, 1),
                              nn.Conv2d(128, hidden, 3, padding=1))
                for _ in range(2)]))
        self.outputs32 = nn.ModuleList(
            [nn.Conv2d(128, hidden, 3, padding=1) for _ in range(2)])

    def forward(self, x) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        x08 = self.trunk(x)
        x16 = self.layer4(x08)
        x32 = self.layer5(x16)
        return [tuple(m(feat) for m in heads) for feat, heads in
                ((x08, self.outputs08), (x16, self.outputs16),
                 (x32, self.outputs32))]


def build_corr_pyramid(fmap1, fmap2, num_levels: int = CORR_LEVELS):
    """All-pairs 1-D correlation of (N, D, H, W) feature maps along the
    rows, and its pyramid of pairwise column averages: (N, H, W1, W2 /
    2^l) per level."""
    d = fmap1.shape[1]
    corr = torch.einsum("ndhw,ndhv->nhwv", fmap1, fmap2) / math.sqrt(d)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        w2 = corr.shape[-1] // 2
        corr = 0.5 * (corr[..., :2 * w2:2] + corr[..., 1:2 * w2:2])
        pyramid.append(corr)
    return pyramid


def _window(values, x, size: int):
    """Linear interpolation of ``values`` (..., L) at x + k, k = 0 ..
    size-1 (x (...), float), zero outside [0, L - 1]: each sample's left
    corner at its clamped floor column, the right corner one column past
    that clamped column, as the JAX package gathers them.  (So a sample
    whose floor is -1 reads column 1 for its right corner, where the
    reference's grid_sample reads column 0: a fault of the JAX package,
    kept for parity with it.)"""
    n = values.shape[-1]
    x0 = torch.floor(x)
    a = (x - x0)[..., None]
    cols = x0[..., None] + torch.arange(size, dtype=x.dtype,
                                        device=x.device)
    i0 = torch.clamp(torch.nan_to_num(cols), 0, n - 1).long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    c0 = torch.where((cols >= 0) & (cols <= n - 1),
                     torch.gather(values, -1, i0), 0.0)
    c1 = torch.where((cols + 1 >= 0) & (cols + 1 <= n - 1),
                     torch.gather(values, -1, i1), 0.0)
    return c0 * (1 - a) + c1 * a


def lookup_corr(pyramid, coords_x, radius: int = CORR_RADIUS):
    """Sample each level at x / 2^l + dx, dx in [-r, r], for x
    ``coords_x`` (N, H, W): (N, levels * (2r + 1), H, W), level-major."""
    outs = []
    for lvl, corr in enumerate(pyramid):
        x = coords_x / (2 ** lvl) - radius
        outs.append(_window(corr, x, 2 * radius + 1))
    return torch.cat(outs, dim=-1).permute(0, 3, 1, 2)


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int):
        super().__init__()
        self.convz = nn.Conv2d(hidden + cin, hidden, 3, padding=1)
        self.convr = nn.Conv2d(hidden + cin, hidden, 3, padding=1)
        self.convq = nn.Conv2d(hidden + cin, hidden, 3, padding=1)

    def forward(self, h, x, cz, cr, cq):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int = CORR_LEVELS * (2 * CORR_RADIUS + 1)):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv = nn.Conv2d(128, 126, 3, padding=1)

    def forward(self, flow, corr):
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class FlowHead(nn.Module):
    def __init__(self, cin: int = HIDDEN, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


def _pool2x(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def _interp_to(x, ref):
    """Bilinear resize to ``ref``'s size, align_corners=True."""
    if x.shape[2:] == ref.shape[2:]:
        return x
    return F.interpolate(x, ref.shape[2:], mode="bilinear",
                         align_corners=True)


def _mask_head(cin: int, factor: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, 256, 3, padding=1),
                         nn.ReLU(inplace=True),
                         nn.Conv2d(256, factor ** 2 * 9, 1))


class UpdateBlock(nn.Module):
    """Multi-scale GRU update, flow head and upsampling mask."""

    def __init__(self, factor: int = 4):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru08 = ConvGRU(HIDDEN, 128 + HIDDEN)
        self.gru16 = ConvGRU(HIDDEN, 2 * HIDDEN)
        self.gru32 = ConvGRU(HIDDEN, HIDDEN)
        self.flow_head = FlowHead(HIDDEN)
        self.mask = _mask_head(HIDDEN, factor)

    def forward(self, nets, inps, corr, flow, with_mask: bool = True):
        net08, net16, net32 = nets
        net32 = self.gru32(net32, _pool2x(net16), *inps[2])
        net16 = self.gru16(net16, torch.cat(
            [_pool2x(net08), _interp_to(net32, net16)], dim=1), *inps[1])
        motion = self.encoder(flow, corr)
        net08 = self.gru08(net08, torch.cat(
            [motion, _interp_to(net16, net08)], dim=1), *inps[0])
        delta = self.flow_head(net08)
        mask = 0.25 * self.mask(net08) if with_mask else None
        return (net08, net16, net32), mask, delta


def convex_upsample(flow, mask, factor: int):
    """Mask-weighted convex combination of each coarse pixel's 3x3
    neighbourhood: flow (N, D, h, w), mask (N, 9 f^2, h, w) ->
    (N, D, f h, f w)."""
    n, d, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, factor, factor, h, w), dim=2)
    up = F.unfold(factor * flow, [3, 3], padding=1).view(n, d, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, d, factor * h, factor * w)


class RAFTStereo(nn.Module):
    """Images (N, 3, H, W) in [0, 1] (the reference takes [0, 255]) ->
    (N, H, W) horizontal disparity flow.  Inference only."""

    def __init__(self, iters: int = 32, downsample: int = 2):
        super().__init__()
        self.iters = iters
        self.downsample = downsample
        self.fnet = BasicEncoder(256, "instance", downsample)
        self.cnet = MultiBasicEncoder("batch", downsample)
        self.context_zqr_convs = nn.ModuleList(
            [nn.Conv2d(HIDDEN, 3 * HIDDEN, 3, padding=1) for _ in range(3)])
        self.update_block = UpdateBlock(2 ** downsample)
        self.eval()

    def forward(self, image1, image2, iters: int | None = None):
        iters = self.iters if iters is None else iters
        x1 = 2.0 * image1 - 1.0
        x2 = 2.0 * image2 - 1.0
        b = image1.shape[0]
        fmaps = self.fnet(torch.cat([x1, x2]))
        pyramid = build_corr_pyramid(fmaps[:b], fmaps[b:])
        ctx = self.cnet(x1)
        nets = tuple(torch.tanh(h) for h, _ in ctx)
        inps = [conv(torch.relu(c)).split(HIDDEN, dim=1)
                for (_, c), conv in zip(ctx, self.context_zqr_convs)]
        n, _, h, w = fmaps.shape
        xs = torch.arange(w, dtype=torch.float32,
                          device=image1.device).expand(b, h, w)
        dx = torch.zeros_like(xs)
        zero = torch.zeros_like(xs)
        mask = None
        for it in range(iters):
            corr = lookup_corr(pyramid, xs + dx)
            flow = torch.stack([dx, zero], dim=1)
            nets, mask, delta = self.update_block(
                nets, inps, corr, flow, with_mask=it == iters - 1)
            dx = dx + delta[:, 0]   # epipolar: the vertical flow stays 0
        up = convex_upsample(torch.stack([dx, zero], dim=1), mask,
                             2 ** self.downsample)
        return up[:, 0]


def depth_from_disparity(disp, fx=882.0850326, baseline=5.8513759749420302e-3,
                         cx1=445.06146749, cx2=445.061467):
    """RAFT disparity flow -> depth with the reference's stereo rig."""
    return (fx * baseline) / (-disp + (cx2 - cx1))


class InputPadder:
    """Edge-replicate padding of NCHW images so H and W are multiples of
    ``divis_by``: "sintel" splits the padding around both edges, any other
    mode pads the rows at the bottom only."""

    def __init__(self, dims, mode: str = "sintel", divis_by: int = 8):
        self.ht, self.wd = int(dims[-2]), int(dims[-1])
        pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
        pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs):
        out = [F.pad(x, self._pad, mode="replicate") for x in inputs]
        return out if len(out) > 1 else out[0]

    def unpad(self, x):
        l, r, t, b = self._pad
        ht, wd = x.shape[-2:]
        return x[..., t:ht - b, l:wd - r]
