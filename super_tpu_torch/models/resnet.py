"""ResNet feature-pyramid encoder in torchvision's key layout (counterpart
of super_tpu/models/resnet.py).

The reference's depth and segmentation nets are built on torchvision
ResNets: ``conv1``, ``bn1``, ``layer{1..4}.{b}.conv{1,2[,3]}`` /
``bn{1,2[,3]}`` / ``downsample.{0,1}``.  The encoder returns the 5-level
pyramid [relu1, layer1 .. layer4].  At ``output_stride=16`` the last stage
trades its stride for dilation 2 in every convolution of the stage, as
segmentation_models_pytorch's ``make_dilated`` does (weights unchanged).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

LAYERS = {
    18: ([2, 2, 2, 2], "basic"),
    34: ([3, 4, 6, 3], "basic"),
    50: ([3, 4, 6, 3], "bottleneck"),
    101: ([3, 4, 23, 3], "bottleneck"),
    152: ([3, 8, 36, 3], "bottleneck"),
}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv3(cin, cout, stride=1, dilation=1):
    return nn.Conv2d(cin, cout, 3, stride, padding=dilation,
                     dilation=dilation, bias=False)


def _downsample(cin, cout, stride):
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                         nn.BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        self.conv1 = _conv3(cin, planes, stride, dilation)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv3(planes, planes, 1, dilation)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (_downsample(cin, planes, stride) if downsample
                           else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv3(planes, planes, stride, dilation)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * planes)
        self.downsample = (_downsample(cin, 4 * planes, stride) if downsample
                           else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(out + x)


class ResNetEncoder(nn.Module):
    """5-level feature pyramid of an (N, 3, H, W) image in [0, 1].

    ``normalize``: "monodepth2" ((x - 0.45) / 0.225, the monodepth2
    encoder's input scaling) or "imagenet" (the segmentation nets')."""

    def __init__(self, num_layers: int = 18, normalize: str = "monodepth2",
                 output_stride: int = 32):
        super().__init__()
        blocks, kind = LAYERS[num_layers]
        self.normalize = normalize
        # Not in the state dict (the checkpoints carry no such entries).
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).reshape(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).reshape(
            1, 3, 1, 1), persistent=False)
        block_cls = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for li, (width, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                                   blocks)):
            stride = 1 if li == 0 else 2
            dilation = 1
            if output_stride == 16 and li == 3:
                stride, dilation = 1, 2
            layer = []
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                down = bi == 0 and (stride != 1
                                    or cin != width * block_cls.expansion)
                layer.append(block_cls(cin, width, s, dilation, down))
                cin = width * block_cls.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        self.num_ch_enc = ((64, 64, 128, 256, 512) if kind == "basic"
                           else (64, 256, 512, 1024, 2048))

    def forward(self, x) -> List[torch.Tensor]:
        if self.normalize == "monodepth2":
            x = (x - 0.45) / 0.225
        elif self.normalize == "imagenet":
            x = (x - self.mean) / self.std
        x = torch.relu(self.bn1(self.conv1(x)))
        feats = [x]
        x = self.maxpool(x)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        return feats
