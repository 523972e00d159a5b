#!/usr/bin/env python
"""SuPer tracking CLI of the PyTorch port (counterpart of the root
run_super.py, with the same flags and defaults).

Runs the LM tracking pipeline on the card (``--cpu`` for the CPU) on
either:
- a synthetic deforming-surface sequence (``--synthetic``, or no
  ``--data_dir``), or
- a SuPer-layout data directory (``--data_dir`` with rgb/ and depth/ and an
  optional tracking-GT .npy), read by data/superv1.py, whose decoder the
  metrics JSON names under ``loader``.
The metrics JSON names the step's loop under ``loop``: ``"graph"``, the
compiled step replayed a frame on the card (pipeline.py), or
``"eager"``.

Examples:
  python -m super_tpu_torch.run_super --synthetic --num_frames 50
  python -m super_tpu_torch.run_super --data_dir ~/v1_520_pairs \\
      --tracking_gt_file left_pts.npy
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SuPer tracker (PyTorch port)")
    p.add_argument("--synthetic", action="store_true",
                   help="run on a generated deforming surface with exact GT")
    p.add_argument("--num_frames", type=int, default=50)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--mesh_step_size", type=int, default=30)
    p.add_argument("--num_optimize_iterations", type=int, default=10)
    p.add_argument("--association", default=None,
                   choices=["per_iteration", "per_frame"],
                   help="point-plane data association (default: config "
                        "default, per_iteration = reference semantics)")
    p.add_argument("--linear_solver", default=None,
                   choices=["cholesky", "pcg", "pcg_pallas", "pairs_fused"])
    p.add_argument("--pcg_iterations", type=int, default=None)
    p.add_argument("--gram_sum_dtype", default=None, choices=["f32", "bf16"])
    p.add_argument("--method", default="super",
                   choices=["super", "semantic-super"])
    p.add_argument("--data", default="superv1", choices=["superv1", "superv2"])
    p.add_argument("--data_dir", default=None)
    p.add_argument("--rgb_dir", default="rgb")
    p.add_argument("--depth_dir", default="depth")
    p.add_argument("--seg_dir", default="seg")
    p.add_argument("--start_id", type=int, default=4)
    p.add_argument("--end_id", type=int, default=521)
    p.add_argument("--load_depth", action="store_true", default=True)
    p.add_argument("--load_seg", action="store_true")
    p.add_argument("--depth_ext", default=".npy")
    p.add_argument("--img_ext", default=".png")
    p.add_argument("--min_depth", type=float, default=0.1)
    p.add_argument("--max_depth", type=float, default=80.0)
    p.add_argument("--tracking_gt_file", default=None)
    p.add_argument("--sf_point_plane", action="store_true", default=True)
    p.add_argument("--mesh_arap", action="store_true", default=True)
    p.add_argument("--mesh_rot", action="store_true", default=True)
    p.add_argument("--use_derived_gradient", action="store_true", default=True)
    p.add_argument("--normal_model", default="8neighbors",
                   choices=["naive", "8neighbors"])
    p.add_argument("--th_dist", type=float, default=0.1)
    p.add_argument("--th_cosine_ang", type=float, default=0.4)
    p.add_argument("--th_time_steps", type=int, default=30)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--output_json", default=None)
    p.add_argument("--verbose", action="store_true")
    # In-the-loop perception (factory.py)
    p.add_argument("--depth_model", default=None,
                   choices=["monodepth2_stereo", "raft_stereo"],
                   help="infer depth instead of --load_depth")
    p.add_argument("--pretrained_depth_checkpoint_dir", default=None)
    p.add_argument("--depth_filter_kernel_size", type=int, default=-1,
                   help="Gaussian-blur the predicted disparity when >0")
    p.add_argument("--pretrained_encoder_checkpoint_dir", default=None,
                   help="monodepth2 encoder.pth (decoder via "
                        "--pretrained_depth_checkpoint_dir)")
    p.add_argument("--seg_model", default=None,
                   choices=["deeplabv3plus", "unet", "unet++", "manet"])
    p.add_argument("--pretrained_seg_checkpoint_dir", default=None)
    # Optical-flow correspondence loss (autograd path)
    p.add_argument("--sf_corr", action="store_true")
    p.add_argument("--sf_corr_weight", type=float, default=1e-3)
    p.add_argument("--sf_corr_match_renderimg", action="store_true")
    p.add_argument("--flow_checkpoint", default=None,
                   help="torchvision raft_large state dict for sf_corr")
    return p


def cli_device(args) -> torch.device:
    """The CPU with ``--cpu``, else the card; no card and no ``--cpu``
    exits with a message."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --cpu to run on the CPU)")
    return torch.device("cuda", 0)


def build_cli_models(cfg, args, device):
    """factory.build_models from the CLI flags; None when no net is in the
    loop."""
    if not (cfg.depth_model or cfg.seg_model or cfg.losses.sf_corr):
        return None
    from super_tpu_torch.factory import build_models
    return build_models(
        cfg,
        depth_checkpoint=args.pretrained_depth_checkpoint_dir,
        encoder_checkpoint=args.pretrained_encoder_checkpoint_dir,
        seg_checkpoint=args.pretrained_seg_checkpoint_dir,
        flow_checkpoint=args.flow_checkpoint,
        device=device,
    )


def emit_metrics(metrics, args) -> None:
    print(json.dumps(metrics, indent=2))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(metrics, f)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = cli_device(args)

    from super_tpu_torch.config import CapacityConfig, LossConfig, SuPerConfig
    from super_tpu_torch.core.graph import grid_layout
    from super_tpu_torch.pipeline import SuPerPipeline

    anchors, _, _ = grid_layout(args.height, args.width, args.mesh_step_size)
    # The node capacity is a multiple of 64, not a power of two: the graph
    # never grows past the frame-0 grid, and the 7J Cholesky is cubic in it.
    node_cap = max(64, -(-len(anchors) // 64) * 64)
    # 1.25 x the pixels, in whole 32,768-slot chunks: room for fusion's
    # adds without assembly work on unused slots.
    chunk_al = 32768
    surfel_cap = -(-int(1.25 * args.height * args.width) // chunk_al) * chunk_al
    surfel_cap = max(surfel_cap, chunk_al)
    cfg = SuPerConfig(
        method=args.method,
        data=args.data,
        height=args.height,
        width=args.width,
        mesh_step_size=args.mesh_step_size,
        normal_model=args.normal_model,
        th_dist=args.th_dist,
        th_cosine_ang=args.th_cosine_ang,
        th_time_steps=args.th_time_steps,
        depth_model=args.depth_model,
        depth_filter_kernel_size=args.depth_filter_kernel_size,
        seg_model=args.seg_model,
        losses=LossConfig(
            sf_point_plane=args.sf_point_plane,
            mesh_arap=args.mesh_arap,
            mesh_rot=args.mesh_rot,
            sf_corr=args.sf_corr,
            sf_corr_weight=args.sf_corr_weight,
            sf_corr_match_renderimg=args.sf_corr_match_renderimg,
        ),
        capacity=CapacityConfig(
            surfel_capacity=surfel_cap,
            node_capacity=node_cap,
            edge_capacity=4 * node_cap,
            triangle_capacity=2 * node_cap,
        ),
    )
    solver_kw = dict(num_iterations=args.num_optimize_iterations,
                     use_derived_gradient=args.use_derived_gradient)
    if node_cap > 512:  # dense ED graph: scale the tuple capacity, pair CG
        solver_kw.update(assembly_tuple_cap=8 * node_cap,
                         assembly_pair_cap=16 * node_cap,
                         linear_solver="pairs_fused", pcg_iterations=32,
                         gram_sum_dtype="bf16")
    if args.association:
        solver_kw.update(association=args.association)
    if args.linear_solver:
        solver_kw.update(linear_solver=args.linear_solver)
    if args.pcg_iterations:
        solver_kw.update(pcg_iterations=args.pcg_iterations)
    if args.gram_sum_dtype:
        solver_kw.update(gram_sum_dtype=args.gram_sum_dtype)
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, **solver_kw))

    if cfg.losses.sf_corr and args.use_derived_gradient:
        print("warning: sf_corr applies to the autograd (GraphFit) path "
              "only; the LM path ignores it (as in the reference).",
              file=sys.stderr)
    models = build_cli_models(cfg, args, device)

    if args.synthetic or args.data_dir is None:
        from super_tpu_torch.data.synthetic import default_intrinsics, generate
        intr = default_intrinsics(args.height, args.width, device="cpu")
        seq = generate(args.num_frames, args.height, args.width, intr=intr)
        pipe = SuPerPipeline(cfg, intr, device=device)
        depths = None if cfg.depth_model else seq.depths
        metrics = pipe.run(depths, seq.colors, gt_xy=seq.gt_xy,
                           gt_valid=seq.gt_valid, models=models,
                           verbose=args.verbose)
    else:
        from super_tpu_torch.data.superv1 import load_gt, load_sequence
        intr, loaded = load_sequence(cfg, args, device="cpu")
        pipe = SuPerPipeline(cfg, intr, device=device)
        depths = None if cfg.depth_model else loaded.depths
        metrics = pipe.run(depths, loaded.colors,
                           gt_xy=loaded.gt_xy, gt_valid=loaded.gt_valid,
                           segs=loaded.segs, seg_confs=loaded.seg_confs,
                           models=models, verbose=args.verbose)
        metrics["loader"] = loaded.loader
        if args.tracking_gt_file:
            # Co-report the original C++ SuPer baseline bundled in the GT
            # file, where it is there.
            from super_tpu_torch.utils import evaluation
            _, bundle = load_gt(args.data_dir, args.tracking_gt_file)
            cpp = evaluation.baseline_errors_from_bundle(bundle)
            if cpp:
                cpp_sum = evaluation.summarize(cpp)
                metrics["super_cpp_mean"] = cpp_sum["reproj_mean"]
                metrics["super_cpp_std"] = cpp_sum["reproj_std"]

    metrics["loop"] = pipe.loop
    emit_metrics(metrics, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
