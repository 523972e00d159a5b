"""The port's scatter assembly with the moving target against the
independent NumPy f64 golden port of the reference loop
(tests/golden_lm.py; the JAX package's tests/test_golden_lm.py, whose
setup this file repeats): the normal equations against the golden
finite-difference ones, the classic loop step for step, and lm_solve's
optimum.  The port's plain path carries f64: the context, the
intrinsics and beta are f64 here."""

import dataclasses

import numpy as np
import pytest
import torch

from helpers import tiny_scene
from torch_helpers import port_config, port_frame, port_intr, port_state

import golden_lm as gold

from super_tpu.core.tracker import init_tracker
from super_tpu_torch.core import lm as tlm
from super_tpu_torch.core import losses as tloss


def _to64(tree):
    """Floating tensors of a NamedTuple tree as f64."""
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if tree is None or not isinstance(tree, tuple):
        return tree
    return type(tree)(*(_to64(v) for v in tree))


@pytest.fixture(scope="module")
def setup():
    cfg, intr, seq, frames = tiny_scene(num_frames=3, h=24, w=32, step=8)
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, assembly_mode="scatter", association="per_iteration",
        lm_schedule="classic"))
    st = init_tracker(cfg, frames[0])
    # Surfels nudged off the pixel grid, as tests/test_golden_lm.py does
    # (pixel-centre knife edges would flip masks between implementations).
    rng = np.random.default_rng(17)
    pts = np.asarray(st.surfels.points)
    pts = (pts + 2e-4 * rng.standard_normal(pts.shape)).astype(np.float32)
    st = st._replace(surfels=st.surfels._replace(points=pts))
    frame = frames[1]
    inp = gold.GoldenInputs(
        p=np.asarray(st.surfels.points.T, np.float64),
        sf_active=np.asarray(st.surfels.active),
        knn_idx=np.asarray(st.surfels.knn_idx.T),
        knn_w=np.asarray(st.surfels.knn_w.T, np.float64),
        g=np.asarray(st.graph.points, np.float64),
        ed_active=np.asarray(st.graph.active),
        ed_knn=np.asarray(st.graph.knn_idx),
        trg_points=np.asarray(frame.points.T, np.float64),
        trg_norms=np.asarray(frame.norms.T, np.float64),
        index_map=np.asarray(frame.index_map(cfg.height, cfg.width)),
        fx=float(intr.fx), fy=float(intr.fy),
        cx=float(intr.cx), cy=float(intr.cy),
        w_data=cfg.losses.sf_point_plane_weight,
        w_arap=cfg.losses.mesh_arap_weight,
        w_rot=cfg.losses.mesh_rot_weight)
    pcfg = port_config(cfg)
    ps = _to64(port_state(st))
    ctx = tloss.prepare_lm(pcfg, ps.surfels, ps.graph,
                           _to64(port_frame(frame)))
    assert ctx.layout is None and ctx.sf_points.dtype == torch.float64
    return pcfg, _to64(port_intr(intr)), inp, ctx


def test_normal_equations_match_fd_golden(setup):
    """Analytic (J^T J, J^T r, cost) of the scatter assembly against the
    golden finite-difference normal equations at a generic beta:
    tests/test_golden_lm.py's tolerances (2e-6 of the largest entry, the
    cost to 1e-9)."""
    cfg, intr, inp, ctx = setup
    j_cap = ctx.ed_mask.shape[0]
    rng = np.random.default_rng(2)
    beta_np = np.tile(np.array([1.0, 0, 0, 0, 0, 0, 0]), (j_cap, 1))
    beta_np += 0.005 * rng.normal(size=beta_np.shape)
    jac, r0 = gold.fd_jacobian(inp, beta_np)
    jtj_g = jac.T @ jac
    jtr_g = -jac.T @ r0
    jtj, jtr, cost = tloss.assemble_normal_equations(
        cfg, ctx, torch.as_tensor(beta_np), intr, None)
    assert jtj.dtype == torch.float64
    scale = np.max(np.abs(jtj_g)) + 1e-12
    np.testing.assert_allclose(jtj.numpy() / scale, jtj_g / scale, atol=2e-6)
    rscale = np.max(np.abs(jtr_g)) + 1e-12
    np.testing.assert_allclose(jtr.numpy() / rscale, jtr_g / rscale,
                               atol=2e-6)
    np.testing.assert_allclose(float(cost), float(np.sum(r0 * r0)),
                               rtol=1e-9)


def test_lm_trajectory_matches_golden(setup):
    """Step for step, tests/test_golden_lm.py's classic loop on the port's
    assembly and cost: candidate costs (1e-6), accept decisions, damping
    (1e-9) and beta (1e-5) match the golden reference loop."""
    cfg, intr, inp, ctx = setup
    num_iter = 6
    _, hist = gold.golden_lm(inp, num_iter)
    j_cap = ctx.ed_mask.shape[0]
    beta = torch.zeros((j_cap, 7), dtype=torch.float64)
    beta[:, 0] = 1.0
    best_beta, best_cost = beta, 1e10
    u, v = cfg.solver.lm_damping_init, cfg.solver.lm_damping_factor
    for it in range(num_iter):
        jtj, jtr, _ = tloss.assemble_normal_equations(cfg, ctx, beta, intr,
                                                      None)
        a = jtj + u * torch.eye(7 * j_cap, dtype=torch.float64)
        delta = torch.linalg.solve(a, jtr)
        beta_new = beta + delta.reshape(j_cap, 7)
        cand = float(tloss.total_cost(cfg, ctx, beta_new, intr, None))
        accepted = cand < best_cost
        g = hist[it]
        np.testing.assert_allclose(cand, g.cand_cost, rtol=1e-6,
                                   err_msg=f"iteration {it} candidate cost")
        assert accepted == g.accepted, f"iteration {it} accept decision"
        if accepted:
            best_beta, best_cost = beta_new, cand
            u /= v
            beta = beta_new
        else:
            u *= v
            beta = best_beta
        np.testing.assert_allclose(u, g.u, rtol=1e-9)
        np.testing.assert_allclose(beta.numpy(), g.beta, rtol=1e-5,
                                   atol=1e-8, err_msg=f"iteration {it} beta")


def test_lm_solve_reaches_golden_optimum(setup):
    """The port's classic lm_solve (Jacobi-scaled Cholesky) with the
    scatter assembly lands on the golden loop's final beta (1e-5) and last
    accepted cost (1e-6)."""
    cfg, intr, inp, ctx = setup
    num_iter = 6
    best_g, hist = gold.golden_lm(inp, num_iter)
    cfg6 = cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                  num_iterations=num_iter))
    res = tlm.lm_solve(cfg6, ctx, intr)
    np.testing.assert_allclose(res.beta.numpy(), best_g, rtol=1e-5,
                               atol=1e-8)
    accepted = [h.cand_cost for h in hist if h.accepted]
    np.testing.assert_allclose(float(res.cost), accepted[-1], rtol=1e-6)
