#!/usr/bin/env python
"""Semantic-SuPer tracking CLI of the PyTorch port (counterpart of the root
run_semantic_super.py, with the same flags and defaults).

Runs the semantic-aware tracker on the card (``--cpu`` for the CPU): soft
or hard segmentation-weighted ICP, face-area regularisation, boundary-morph
and render losses on the autograd path.  A data directory's segmentations
are read with its frames (data/superv1.py, ``load_seg``).

Examples:
  python -m super_tpu_torch.run_semantic_super --synthetic --num_frames 30
  python -m super_tpu_torch.run_semantic_super --data_dir ~/trial_3 \\
      --tracking_gt_file left_pts.npy
"""

from __future__ import annotations

import dataclasses
import sys

from super_tpu_torch.run_super import (
    build_argparser,
    build_cli_models,
    cli_device,
    emit_metrics,
)


def main(argv=None) -> int:
    p = build_argparser()
    p.set_defaults(method="semantic-super", data="superv2", start_id=0,
                   end_id=151, use_derived_gradient=False)
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--hard_seg", action="store_true")
    p.add_argument("--sf_soft_seg_point_plane", action="store_true",
                   default=True)
    p.add_argument("--sf_bn_morph", action="store_true", default=True)
    p.add_argument("--render_loss", action="store_true", default=False)
    p.add_argument("--mesh_face", action="store_true", default=True)
    p.add_argument("--optimizer", default="Adam")
    p.add_argument("--learning_rate", type=float, default=2e-4)
    args = p.parse_args(argv)
    device = cli_device(args)

    from super_tpu_torch.config import CapacityConfig, LossConfig, SuPerConfig
    from super_tpu_torch.core.graph import grid_layout
    from super_tpu_torch.pipeline import SuPerPipeline

    anchors, _, _ = grid_layout(args.height, args.width, args.mesh_step_size)

    def pow2_at_least(n):
        v = 1
        while v < n:
            v *= 2
        return v

    node_cap = pow2_at_least(len(anchors))
    cfg = SuPerConfig(
        method="semantic-super",
        data=args.data,
        height=args.height,
        width=args.width,
        mesh_step_size=args.mesh_step_size,
        num_classes=args.num_classes,
        hard_seg=args.hard_seg,
        load_seg=True,
        depth_model=args.depth_model,
        seg_model=args.seg_model,
        losses=LossConfig(
            sf_point_plane=False,
            sf_soft_seg_point_plane=not args.hard_seg,
            sf_hard_seg_point_plane=args.hard_seg,
            mesh_arap=False,
            mesh_rot=True,
            mesh_face=args.mesh_face,
            sf_bn_morph=args.sf_bn_morph,
            render_loss=args.render_loss,
            sf_corr=args.sf_corr,
            sf_corr_weight=args.sf_corr_weight,
            sf_corr_match_renderimg=args.sf_corr_match_renderimg,
        ),
        capacity=CapacityConfig(
            surfel_capacity=pow2_at_least(2 * args.height * args.width),
            node_capacity=node_cap,
            edge_capacity=4 * node_cap,
            triangle_capacity=2 * node_cap,
        ),
    )
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver,
        use_derived_gradient=False,
        optimizer=args.optimizer,
        learning_rate=args.learning_rate,
        num_iterations=args.num_optimize_iterations))

    models = build_cli_models(cfg, args, device)

    if args.synthetic or args.data_dir is None:
        from super_tpu_torch.data.synthetic import default_intrinsics, generate
        intr = default_intrinsics(args.height, args.width, device="cpu")
        seq = generate(args.num_frames, args.height, args.width, intr=intr,
                       num_classes=args.num_classes)
        pipe = SuPerPipeline(cfg, intr, device=device)
        metrics = pipe.run(seq.depths, seq.colors, gt_xy=seq.gt_xy,
                           gt_valid=seq.gt_valid, segs=seq.segs,
                           seg_confs=seq.seg_confs, models=models,
                           verbose=args.verbose)
    else:
        from super_tpu_torch.data.superv1 import load_sequence
        intr, loaded = load_sequence(cfg, args, device="cpu")
        pipe = SuPerPipeline(cfg, intr, device=device)
        metrics = pipe.run(loaded.depths, loaded.colors,
                           gt_xy=loaded.gt_xy, gt_valid=loaded.gt_valid,
                           segs=loaded.segs, seg_confs=loaded.seg_confs,
                           models=models, verbose=args.verbose)
        metrics["loader"] = loaded.loader

    metrics["loop"] = pipe.loop
    emit_metrics(metrics, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
