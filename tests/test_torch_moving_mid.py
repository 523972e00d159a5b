"""Parity of the port's moving-target data term with the JAX package's on
the headline's graph at a quarter of its pixels: 240 x 320 at mesh step 15
lays out the same 22 x 16 grid of ED node anchors (352 in a capacity of
384) as the headline's 480 x 640 at step 30, with the headline's assembly
settings (``lm_workload_config``: pad group 64, tuple and pair caps
4096).  The rows and the normal equations of frame 1, at a beta off the
identity, against both JAX forms (``data_chunk_jacobian`` into
``tuple_gram_pallas``, and the per-chunk ``moving_chunk_partial_fm``).
test_torch_moving.py holds the same at 48 x 64 with its few nodes; at this
size a few samples also fall an ULP to either side of a pixel line on the
two sides, and the tests say how those are held."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, headline_grid_config, port_config, \
    port_frame, port_intr, port_state, scene

from super_tpu.core import losses as jloss
from super_tpu.core.tracker import init_tracker
from super_tpu.geometry.camera import project_points as jproject
from super_tpu.geometry.quaternion import IDENTITY_DQ
from super_tpu_torch.core import losses as tloss
from super_tpu_torch.geometry.camera import project_points as tproject


def _jax_config(backend):
    """The headline's node grid at 240 x 320 with the moving target and f32
    pair sums."""
    return headline_grid_config(association="per_iteration",
                                assembly_backend=backend, assembly_chunk=4096,
                                gram_sum_dtype="f32")


@pytest.fixture(scope="module")
def frame1():
    cfg = _jax_config("pallas")
    intr, _, frames = scene(2, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    ctx = jax.jit(lambda s, g, f: jloss.prepare_lm(cfg, s, g, f))(
        st.surfels, st.graph, frames[1])
    ps = port_state(st)
    pctx = tloss.prepare_lm(port_config(cfg), ps.surfels, ps.graph,
                            port_frame(frames[1]))
    rng = np.random.default_rng(5)
    beta = np.tile(np.asarray(IDENTITY_DQ, np.float32),
                   (cfg.capacity.node_capacity, 1))
    beta = beta + (1e-3 * rng.normal(size=beta.shape)).astype(np.float32)
    return intr, st, ctx, pctx, beta


def test_mid_graph_size(frame1):
    """The scene's graph is the headline's: 315 active nodes of 352
    anchors (the pipeline phase of chip_smoke.py reports 315 at 480 x
    640)."""
    st = frame1[1]
    assert st.graph.active.shape == (384,)
    assert 300 <= int(np.sum(np.asarray(st.graph.active))) <= 352


@pytest.fixture(scope="module")
def rows(frame1):
    """Frame 1's moving rows from both sides at the fixture's beta: the
    JAX package's data_chunk_jacobian (g, r) and the port's moving_rows
    (h, pr), and the slots whose sample falls in another bilinear cell on
    the two sides."""
    cfg = _jax_config("pallas")
    intr, _, ctx, pctx, beta = frame1
    np_cap = ctx.sf_mask.shape[0]
    xs, _ = jloss._chunk_xs(ctx, np_cap)
    xs0 = jax.tree.map(lambda a: a[0], xs)
    beta_t = jnp.asarray(beta)[ctx.layout.tuple_nodes]
    w = cfg.losses.sf_point_plane_weight
    r, g, _ = jax.jit(lambda b, bt: jloss._jacobian_of(
        cfg, ctx, b, bt, intr, w, xs0, None))(jnp.asarray(beta), beta_t)
    tp = jax.jit(jloss._blend_warp_fm)(jloss._geom_of(ctx, xs0),
                                       jloss._beta_fm_of(beta_t, xs0))
    jv, ju, _, _ = jproject(tp, intr, cfg.height, cfg.width)
    pintr = port_intr(intr)
    pbeta = torch.as_tensor(beta)
    h, pr = tloss.moving_rows(port_config(cfg), pctx, pbeta, pintr, w)
    pv, pu, _, _ = tproject(tloss._blend_warp(pctx, pbeta), pintr,
                            cfg.height, cfg.width)
    ju, jv, pu, pv = (np.asarray(a, np.float64) for a in (ju, jv, pu, pv))
    live = np.asarray(ctx.sf_mask)
    switched = live & ((np.floor(ju) != np.floor(pu))
                       | (np.floor(jv) != np.floor(pv)))
    return (np.array(g).reshape(np_cap, 28), np.asarray(r), h, pr,
            switched, (ju, jv, pu, pv), live)


def test_moving_rows_mid(rows):
    g, r, h, pr, switched, (ju, jv, pu, pv), live = rows
    # A warped point computed in another f32 order lands up to an ULP
    # away; where that crosses a pixel line the bilinear sample takes
    # the next cell, whose gradient jumps at a depth edge (a row of ~0.3
    # becomes one of ~300).  Such slots must be rare and have a
    # coordinate within 2 ULPs of a pixel line.
    near = np.zeros_like(live)
    for a in (ju, jv, pu, pv):
        near |= np.abs(a - np.round(a)) <= 2 * np.spacing(
            np.float32(a)).astype(np.float64)
    assert switched.sum() <= 1e-4 * live.sum(), int(switched.sum())
    assert not (switched & ~near).any()
    # The other rows: test_torch_moving.py's tolerances, 1e-4 of the
    # largest row entry (the chain rule and the collapsed normal cancel
    # differently in single rows), residuals to 5e-7 (f32 on points
    # ~0.5 m deep; the bilinear sample is continuous across a cell
    # switch, so every residual is held).
    keep = ~switched
    close(g[keep], h.numpy()[keep], atol=1e-4 * float(np.abs(g).max()),
          name="h")
    close(r, pr, atol=5e-7, name="r")


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_moving_normal_equations_mid(frame1, rows, backend, monkeypatch):
    """The normal equations of the port's rows, with the slots whose cell
    switched taking the JAX package's rows, against the JAX package's
    normal equations: the port's sums of the same rows."""
    g, r, h, pr, switched, _, _ = rows
    cfg = _jax_config(backend)
    intr, _, ctx, pctx, beta = frame1
    jtj, jtr, cost = jax.jit(lambda c, b: jloss.assemble_normal_equations(
        cfg, c, b, intr, assoc=None, with_cost=True))(ctx, jnp.asarray(beta))
    sw = torch.as_tensor(switched)
    h = torch.where(sw[:, None], torch.as_tensor(g), h)
    monkeypatch.setattr(tloss, "moving_rows", lambda *a, **k: (h, pr))
    pjtj, pjtr, pcost = tloss.assemble_normal_equations(
        port_config(cfg), pctx, torch.as_tensor(beta), port_intr(intr), None)
    # test_torch_moving.py's tolerances: 1e-5 of the largest entry, the
    # cost to 1e-5 relative.
    close(jtj, pjtj, atol=1e-5 * float(np.abs(np.asarray(jtj)).max()),
          name="jtj")
    close(jtr, pjtr, atol=1e-5 * float(np.abs(np.asarray(jtr)).max()),
          name="jtr")
    close(cost, pcost, atol=0, rtol=1e-5, name="cost")
