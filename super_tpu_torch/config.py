"""Typed configuration of the PyTorch port (counterpart of
super_tpu/config.py).

The field names, defaults and nesting are those of the JAX package's
configuration, so a config crosses between the two packages as
``dataclasses.asdict`` output (:meth:`SuPerConfig.from_dict`).  The port keeps
its own copy: it imports nothing of ``super_tpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Residual-stack toggles and weights."""

    sf_point_plane: bool = True
    sf_point_plane_weight: float = 1.0
    sf_point_plane_max: float = -1.0
    huber_th: float = -1.0
    mesh_arap: bool = True
    mesh_arap_weight: float = 10.0
    mesh_rot: bool = True
    mesh_rot_weight: float = 1.0
    mesh_face: bool = False
    mesh_face_weight: float = 1.0
    sf_corr: bool = False
    sf_corr_weight: float = 1e-3
    sf_corr_loss_type: str = "point-point"
    sf_corr_match_renderimg: bool = False
    render_loss: bool = False
    render_loss_weight: float = 1e-4
    sf_hard_seg_point_plane: bool = False
    sf_soft_seg_point_plane: bool = False
    sf_bn_morph: bool = False
    sf_bn_morph_weight: float = 0.1


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Per-frame warp-field solver settings.

    The port runs the LM path with ``association`` ``"per_frame"``,
    ``"per_iteration"`` or ``"per_iteration_frozen"``,
    ``lm_hypotheses=1``, the tuple assembly with the pair expansion, either
    ``lm_schedule``, and the ``pairs_fused``, ``cholesky``, ``pcg`` and
    ``pcg_pallas`` solvers, and the autograd path
    (``use_derived_gradient=False``) with ``optimizer`` ``"SGD"`` or
    ``"Adam"``; the other values of these fields belong to later slices and
    raise where they would be taken.
    """

    use_derived_gradient: bool = True
    optimizer: str = "SGD"
    learning_rate: float = 5e-5
    num_iterations: int = 10
    lm_damping_init: float = 10.0
    lm_damping_factor: float = 7.5
    lm_schedule: str = "deferred"
    lm_hypotheses: int = 1
    linear_solver: str = "cholesky"
    pcg_iterations: int = 64
    pcg_tol: float = 1e-12
    assembly_chunk: int = 65536
    moving_premix: bool = False
    assembly_mode: str = "tuple"
    assembly_tuple_cap: int = 4096
    assembly_pad_group: int = 32
    assembly_combine: str = "matmul"
    assembly_expand: str = "pairs"
    assembly_pair_cap: int = 4096
    assembly_backend: str = "xla"
    jtj_dtype: str = "f32"
    # "bf16": the pair-block sums round their values to bf16 and sum in f32.
    gram_sum_dtype: str = "f32"
    jac_dtype: str = "f32"
    association: str = "per_iteration"


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Fixed capacities of the mask-carried state."""

    surfel_capacity: int = 1 << 17
    node_capacity: int = 512
    edge_capacity: int = 2048
    triangle_capacity: int = 1024
    new_surfel_capacity: int = 16384
    proj_map_depth: int = 4
    dup_pixel_cap: Optional[int] = None
    track_capacity: int = 20


@dataclasses.dataclass(frozen=True)
class SuPerConfig:
    """Top-level pipeline config."""

    method: str = "super"
    data: str = "superv1"
    height: int = 480
    width: int = 640
    num_ed_neighbors: int = 4
    num_neighbors: int = 4
    th_dist: float = 0.1
    th_cosine_ang: float = 0.4
    th_time_steps: int = 30
    disable_removing_unstable_surfels: bool = False
    disable_merging_new_surfels: bool = False
    disable_merging_exist_surfels: bool = False
    disable_adding_new_surfels: bool = False
    mesh_step_size: int = 30
    normal_model: str = "8neighbors"
    depth_model: Optional[str] = None
    load_depth: bool = True
    min_depth: float = 0.1
    max_depth: float = 80.0
    depth_width_range: Tuple[float, float] = (0.02, 0.98)
    dilate_invalid_kernel: int = 5
    depth_filter_kernel_size: int = -1
    post_process: bool = False
    load_valid_mask: bool = False
    del_seg_classes: Tuple[int, ...] = ()
    disable_ssim_conf: bool = True
    num_classes: int = 3
    hard_seg: bool = False
    load_seg: bool = False
    seg_model: Optional[str] = None
    renderer_rad: float = 2e-4
    proj_map_mode: str = "sort"
    losses: LossConfig = dataclasses.field(default_factory=LossConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    capacity: CapacityConfig = dataclasses.field(
        default_factory=CapacityConfig)
    save_sample_freq: int = 10
    tracking_gt_file: Optional[str] = None
    edge_ids: Tuple[int, ...] = ()

    @property
    def image_pixels(self) -> int:
        return self.height * self.width

    def replace(self, **kw) -> "SuPerConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "SuPerConfig":
        """Build from ``dataclasses.asdict`` of either package's config."""
        nested = {"losses": LossConfig, "solver": SolverConfig,
                  "capacity": CapacityConfig}
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if f.name in nested:
                v = nested[f.name](**v)
            elif isinstance(v, list):
                v = tuple(v)
            kw[f.name] = v
        return cls(**kw)


def lm_workload_config(height: int = 480, width: int = 640,
                       mesh_step: int = 30) -> SuPerConfig:
    """The LM tracking workload of the JAX package's bench (bench.py,
    build_workload, non-semantic branch) with the tuple-Gram assembly
    backend.  Both of its branches:

    - node_capacity <= 512 (mesh step 30 at 480 x 640: 352 grid anchors in
      a capacity of 384): pad group 64 and one more 32,768-slot chunk of
      surfel capacity (425,984 slots), tuple and pair caps 4096;
    - the dense graph (mesh step 16: 1,200 anchors in 1,216): tuple cap
      8 J and pair cap 16 J (9,728 and 19,456), pad group 32, 393,216
      surfel slots.  Its pair CG takes kernel K1b.
    """
    # The anchor count of core/graph.py:grid_layout.
    nodes = len(range(0, width - 1, mesh_step)) * \
        len(range(0, height - 1, mesh_step))
    node_cap = max(64, -(-nodes // 64) * 64)
    chunk = 32768
    surfel_cap = -(-int(1.25 * height * width) // chunk) * chunk
    solver = dict(association="per_frame", linear_solver="pairs_fused",
                  pcg_iterations=32, gram_sum_dtype="bf16",
                  assembly_backend="pallas")
    if node_cap <= 512:
        surfel_cap += chunk
        solver.update(assembly_pad_group=64)
    else:
        solver.update(assembly_tuple_cap=8 * node_cap,
                      assembly_pair_cap=16 * node_cap)
    return SuPerConfig(
        height=height, width=width, mesh_step_size=mesh_step,
        capacity=CapacityConfig(
            surfel_capacity=surfel_cap, node_capacity=node_cap,
            edge_capacity=4 * node_cap, triangle_capacity=2 * node_cap,
            new_surfel_capacity=8192),
        solver=SolverConfig(**solver))


def semantic_super_config(**overrides) -> SuPerConfig:
    """Semantic-SuPer defaults: the autograd path with SGD, soft-seg ICP,
    face, rotation, boundary-morph and render losses (the JAX package's
    ``semantic_super_config``)."""
    base = SuPerConfig(
        method="semantic-super", data="superv2",
        losses=LossConfig(sf_point_plane=False, sf_soft_seg_point_plane=True,
                          mesh_arap=False, mesh_face=True, sf_bn_morph=True,
                          render_loss=True),
        solver=SolverConfig(use_derived_gradient=False, optimizer="SGD"))
    return dataclasses.replace(base, **overrides)


def semantic_workload_config(height: int = 480, width: int = 640,
                             mesh_step: int = 30) -> SuPerConfig:
    """The semantic workload of the JAX package's bench (bench.py,
    ``build_workload(..., semantic=True)``, the defaults of
    run_semantic_super.py): the autograd fit with Adam at lr 2e-4 for 10
    iterations on soft-seg ICP, face, rotation and boundary-morph losses
    (no render), two classes, given segmentations; the capacities of the
    LM workload without its extra chunk (393,216 surfel slots at 480 x 640,
    352 anchors in 384) and every other solver field at its default."""
    nodes = len(range(0, width - 1, mesh_step)) * \
        len(range(0, height - 1, mesh_step))
    node_cap = max(64, -(-nodes // 64) * 64)
    chunk = 32768
    surfel_cap = -(-int(1.25 * height * width) // chunk) * chunk
    return SuPerConfig(
        method="semantic-super", num_classes=2, load_seg=True,
        height=height, width=width, mesh_step_size=mesh_step,
        losses=LossConfig(sf_point_plane=False, sf_soft_seg_point_plane=True,
                          mesh_arap=False, mesh_rot=True, mesh_face=True,
                          sf_bn_morph=True),
        solver=SolverConfig(use_derived_gradient=False, optimizer="Adam",
                            learning_rate=2e-4),
        capacity=CapacityConfig(
            surfel_capacity=surfel_cap, node_capacity=node_cap,
            edge_capacity=4 * node_cap, triangle_capacity=2 * node_cap,
            new_surfel_capacity=8192))


def e2e_depth_workload_config(height: int = 480, width: int = 640,
                              mesh_step: int = 30) -> SuPerConfig:
    """The live path of the JAX package's bench (bench.py,
    ``measure_e2e_depth``): the LM workload (the headline at mesh step 30)
    with its depth inferred each frame by monodepth2 with the flip
    post-processing."""
    return lm_workload_config(height, width, mesh_step).replace(
        depth_model="monodepth2_stereo", post_process=True)


# The named paths of the tracking step at 480 x 640 that chip_smoke.py and
# profile_step.py drive.
WORKLOADS = ("lm", "dense16", "pcg_pallas", "cholesky", "pcg",
             "per_iteration", "semantic", "e2e_depth")


def workload_config(name: str) -> SuPerConfig:
    """A named path at 480 x 640: ``lm``, the headline (mesh step 30,
    pair-sparse CG by K1); ``dense16``, the dense ED graph (mesh step 16,
    K1b); ``pcg_pallas`` (K3), ``cholesky`` and ``pcg``, the headline with
    that dense-matrix solver; ``per_iteration``, the headline with the
    moving-target association (the JAX bench's ``per_iteration_hz``);
    ``semantic``, the autograd Semantic-SuPer fit (the JAX bench's
    ``semantic_hz``); ``e2e_depth``, the headline with monodepth2's depth
    (the JAX bench's ``e2e_depth_hz``)."""
    if name not in WORKLOADS:
        raise ValueError(f"unknown workload {name!r}; one of {WORKLOADS}")
    if name == "semantic":
        return semantic_workload_config(480, 640)
    if name == "e2e_depth":
        return e2e_depth_workload_config(480, 640)
    cfg = lm_workload_config(480, 640, 16 if name == "dense16" else 30)
    if name == "per_iteration":
        cfg = cfg.replace(solver=dataclasses.replace(
            cfg.solver, association="per_iteration"))
    elif name not in ("lm", "dense16"):
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                     linear_solver=name))
    return cfg
