"""Build the perception nets and load the reference's checkpoints
(counterpart of super_tpu/factory.py).

The reference's ``InitNets``: the depth net (monodepth2 or RAFT-Stereo),
the segmentation net and, for ``sf_corr``, the optical-flow net, per
config.  The port's models hold the reference checkpoints' key layouts,
so a checkpoint loads with ``load_state_dict`` as it is, after the
reference loader's unwrapping (``state_dict``, ``module.`` / ``model.``
prefixes).  Without a checkpoint a model gets seeded random weights
(models.init_random).  Inference runs under ``torch.no_grad``.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.models import init_random


class Models(NamedTuple):
    """The configured nets (each holding its weights), or None."""

    depth_model: Optional[nn.Module]
    seg_model: Optional[nn.Module]
    flow_model: Optional[nn.Module]


def load_torch_state(path: str) -> Dict[str, object]:
    """A checkpoint's state dict: ``checkpoint["state_dict"]`` where it is
    wrapped so, with DataParallel's ``module.`` and Lightning's ``model.``
    prefixes stripped.  Read with torch's weights-only unpickler (tensors
    and plain values, as the reference's checkpoints hold): a file that
    pickles other objects is refused."""
    sd = torch.load(os.path.expanduser(path), map_location="cpu",
                    weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        for pre in ("module.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def build_models(cfg: SuPerConfig,
                 depth_checkpoint: Optional[str] = None,
                 encoder_checkpoint: Optional[str] = None,
                 seg_checkpoint: Optional[str] = None,
                 flow_checkpoint: Optional[str] = None,
                 num_layers: int = 18, seed: int = 0,
                 device="cuda") -> Models:
    """The configured nets on ``device``: monodepth2 from ``encoder.pth``
    and ``depth.pth`` (``encoder_checkpoint`` and ``depth_checkpoint``),
    RAFT-Stereo (32 GRU iterations) from ``depth_checkpoint``, the
    ``seg_model`` architecture from ``seg_checkpoint`` and, with
    ``sf_corr``, RAFT flow (12 iterations) from ``flow_checkpoint`` in
    the original RAFT layout or torchvision's raft_large one.  A net
    without its checkpoint gets random weights drawn from one generator
    seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    depth_model = None
    if cfg.depth_model == "monodepth2_stereo":
        from super_tpu_torch.models.monodepth2 import Monodepth2

        depth_model = Monodepth2(num_layers)
        if depth_checkpoint and encoder_checkpoint:
            depth_model.load_checkpoints(load_torch_state(encoder_checkpoint),
                                         load_torch_state(depth_checkpoint))
        else:
            init_random(depth_model, gen)
    elif cfg.depth_model == "raft_stereo":
        from super_tpu_torch.models.raft_stereo import RAFTStereo

        depth_model = RAFTStereo(iters=32)
        if depth_checkpoint:
            depth_model.load_state_dict(load_torch_state(depth_checkpoint))
        else:
            init_random(depth_model, gen)

    seg_model = None
    if cfg.seg_model is not None:
        from super_tpu_torch.models.segmentation import build_seg_model

        seg_model = build_seg_model(cfg.seg_model, cfg.num_classes,
                                    num_layers)
        if seg_checkpoint:
            seg_model.load_state_dict(load_torch_state(seg_checkpoint))
        else:
            init_random(seg_model, gen)

    flow_model = None
    if cfg.losses.sf_corr:
        from super_tpu_torch.models.raft_flow import (
            RAFTFlow,
            torchvision_raft_keys,
        )

        flow_model = RAFTFlow(iters=12)
        if flow_checkpoint:
            sd = load_torch_state(flow_checkpoint)
            if any(k.startswith(("feature_encoder.", "context_encoder."))
                   for k in sd):
                sd = torchvision_raft_keys(sd)
            flow_model.load_state_dict(sd)
        else:
            init_random(flow_model, gen)

    return Models(*(None if m is None else m.to(device).eval()
                    for m in (depth_model, seg_model, flow_model)))


def _image(x, model):
    return torch.as_tensor(x, dtype=torch.float32,
                           device=next(model.parameters()).device)


def predict_frame_inputs(cfg: SuPerConfig, models: Models, color_chw,
                         right_color_chw=None) -> Dict[str, torch.Tensor]:
    """The configured nets on one frame's (3, H, W) colour in [0, 1] (and
    the right image for RAFT-Stereo): {"depth": (H, W)} and, with a
    segmentation net, "seg" (H, W) and "seg_conf" (C, H, W)."""
    out = {}
    with torch.no_grad():
        model = models.depth_model
        if model is not None:
            color = _image(color_chw, model)
            if cfg.depth_model == "monodepth2_stereo":
                from super_tpu_torch.models.monodepth2 import predict_depth

                _, out["depth"] = predict_depth(
                    model, color, cfg.min_depth, cfg.max_depth,
                    post_process=cfg.post_process,
                    filter_kernel=max(cfg.depth_filter_kernel_size, 0))
            else:
                from super_tpu_torch.models.raft_stereo import (
                    depth_from_disparity,
                )

                if right_color_chw is None:
                    raise ValueError("raft_stereo depth needs the right image")
                disp = model(color[None],
                             _image(right_color_chw, model)[None])[0]
                out["depth"] = depth_from_disparity(disp)
        if models.seg_model is not None:
            from super_tpu_torch.models.segmentation import predict_seg

            out["seg"], out["seg_conf"] = predict_seg(
                models.seg_model, _image(color_chw, models.seg_model),
                hard_seg=cfg.hard_seg)
    return out
