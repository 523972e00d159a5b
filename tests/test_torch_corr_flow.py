"""The optical-flow correspondence term (``sf_corr``) of the port's autograd
fit against the JAX package's, on the tiny semantic scene of
tests/test_torch_autograd.py with the root bench's semantic configuration:
the corr face (point-point and point-plane; a per-frame flow anchored at
the source projections and the flow of the current soft render) with its
gradient, the context's flow plumbing, and a 10-step graph_fit with a
per-frame flow.  The flow comes from one deterministic function of the two
images, written for each package (:func:`_jflow`, :func:`_tflow`), so that
both fits see the same flow from the same images; RAFT itself is held to
the flax model in test_torch_raft_flow.py.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, port_config, port_frame, port_intr, \
    port_state, semantic_config, semantic_scene

from super_tpu import factory as jfactory
from super_tpu.core import optimizer as jopt
from super_tpu.core.tracker import init_tracker
from super_tpu_torch import factory
from super_tpu_torch.core import optimizer as topt


def _jflow(src, trg):
    """The test's flow (N, H, W, 2) of two NHWC images, JAX side."""
    ms, mt = jnp.mean(src, axis=-1), jnp.mean(trg, axis=-1)
    return jnp.stack([1.5 * (mt - ms) + 0.8, 0.9 * ms - 0.6], axis=-1)


def _tflow(src, trg):
    """The same flow (N, 2, H, W) of two NCHW images, port side."""
    ms, mt = torch.mean(src, dim=1), torch.mean(trg, dim=1)
    return torch.stack([1.5 * (mt - ms) + 0.8, 0.9 * ms - 0.6], dim=1)


J_MODELS = jfactory.Models(None, None, None, None,
                           types.SimpleNamespace(apply=lambda p, a, b:
                                                 _jflow(a, b)), None)
T_MODELS = factory.Models(None, None, _tflow)


@pytest.fixture(scope="module")
def corr_scene():
    """The bench's semantic configuration with sf_corr, on the tiny scene:
    {loss type: (cfg, intr, frames, JAX state, JAX ctx, port ctx, ...)}."""
    base = semantic_config(render=False)
    intr, _, frames = semantic_scene(3, base)
    st = jax.jit(lambda f: init_tracker(base, f))(frames[0])
    flow = _jflow(frames[0].color_image.transpose(1, 2, 0)[None],
                  frames[1].color_image.transpose(1, 2, 0)[None])[0]
    flow = flow.transpose(2, 0, 1)
    out = {}
    for kind in ("point-point", "point-plane"):
        cfg = base.replace(losses=dataclasses.replace(
            base.losses, sf_corr=True, sf_corr_loss_type=kind))
        ctx = jopt.prepare_autograd(cfg, st.surfels, st.graph, frames[1],
                                    flow=flow, intr=intr)
        pcfg, ps, pintr = port_config(cfg), port_state(st), port_intr(intr)
        pctx = topt.prepare_autograd(
            pcfg, ps.surfels, ps.graph, port_frame(frames[1]),
            flow=torch.as_tensor(np.asarray(flow)), intr=pintr)
        out[kind] = types.SimpleNamespace(
            cfg=cfg, intr=intr, frames=frames, st=st, ctx=ctx, pcfg=pcfg,
            ps=ps, pctx=pctx, pintr=pintr)
    return out


def _deform(j, seed=0, scale=1e-3):
    d = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (j + 1, 1))
    rng = np.random.default_rng(seed)
    return (d + scale * rng.normal(size=d.shape)).astype(np.float32)


def _corr_both(c, render_flow):
    """The corr face and its gradient at a seeded deformation, JAX and
    port, with the context's per-frame flow or the flow of the render."""
    d = _deform(c.st.graph.capacity)
    jcolor = c.frames[1].color_image
    jfn = tfn = None
    if render_flow:
        # Stop-gradiented, as the JAX package's graph_fit infers it.
        jfn = lambda r: jax.lax.stop_gradient(_jflow(  # noqa: E731
            r.transpose(1, 2, 0)[None],
            jcolor.transpose(1, 2, 0)[None])[0].transpose(2, 0, 1))
        tcolor = torch.as_tensor(np.asarray(jcolor))
        tfn = lambda r: _tflow(r[None], tcolor[None])[0]  # noqa: E731
    lj, gj = jax.jit(jax.value_and_grad(
        lambda dd: jopt.autograd_total(c.cfg, c.ctx, c.st.graph, dd, c.intr,
                                       flow_fn=jfn)[1]["corr"]))(
        jnp.asarray(d))
    dt = torch.tensor(d, requires_grad=True)
    parts = topt.autograd_total(c.pcfg, c.pctx, c.ps.graph, dt, c.pintr,
                                flow_fn=tfn)[1]
    parts["corr"].backward()
    return (lj, gj), (parts["corr"].detach(), dt.grad)


@pytest.mark.parametrize("render_flow", [False, True])
@pytest.mark.parametrize("kind", ["point-point", "point-plane"])
def test_corr_face_matches_jax(corr_scene, kind, render_flow):
    """The corr face at a seeded deformation (1e-3 off the identity), with
    the per-frame flow anchored at the source projections or the flow of
    the current soft render: its value within 1e-5 (a sum of f32 terms
    over the surfels) and its gradient within 1e-4 of the largest entry,
    as tests/test_torch_autograd.py holds the other faces."""
    c = corr_scene[kind]
    (lj, gj), (lt, gt) = _corr_both(c, render_flow)
    assert float(lj) > 0
    close(lj, lt, atol=1e-5 * float(lj), name="corr")
    close(gj, gt, atol=1e-4 * float(np.max(np.abs(np.asarray(gj)))),
          name="d corr / d deform")


def test_prepare_autograd_with_flow(corr_scene):
    c = corr_scene["point-point"]
    close(c.ctx.extras.flow, c.pctx.extras.flow, atol=0, name="flow")
    # The source projections of the (permuted) surfels: an f32 rounding.
    close(c.ctx.extras.src_uv, c.pctx.extras.src_uv, atol=1e-4,
          name="src_uv")


def _jax_fit(c, jit):
    fit = lambda s, f, p: jopt.graph_fit(  # noqa: E731
        c.cfg, s.surfels, s.graph, f, c.intr, models=J_MODELS, prev_color=p)
    args = (c.st, c.frames[1], c.frames[0].color_image)
    if jit:
        return jax.jit(fit)(*args)
    with jax.disable_jit():
        return fit(*args)


def test_graph_fit_with_flow(corr_scene):
    """Ten steps of Adam with the per-frame flow from frame 0's colour to
    frame 1's, held as tests/test_torch_autograd.py holds the fit: within
    1.5 times the JAX package's own jit / eager spread of its jit fit
    (1e-6 if the two agree), the loss likewise."""
    c = corr_scene["point-point"]
    d_jit, l_jit = _jax_fit(c, True)
    d_eager, l_eager = _jax_fit(c, False)
    d_t, l_t = topt.graph_fit(
        c.pcfg, c.ps.surfels, c.ps.graph, port_frame(c.frames[1]), c.pintr,
        models=T_MODELS,
        prev_color=torch.as_tensor(np.asarray(c.frames[0].color_image)))
    spread = float(np.max(np.abs(np.asarray(d_jit) - np.asarray(d_eager))))
    err = float(np.max(np.abs(np.asarray(d_jit) - d_t.numpy())))
    print(f"graph_fit with flow: jit-eager spread {spread:.3g}, "
          f"port-jit {err:.3g}; losses jit {float(l_jit):.6g} eager "
          f"{float(l_eager):.6g} port {float(l_t):.6g}")
    lr = c.cfg.solver.learning_rate
    assert spread < 10 * lr * c.cfg.solver.num_iterations, spread
    assert err <= max(1.5 * spread, 1e-6), (err, spread)
    lspread = abs(float(l_jit) - float(l_eager))
    assert abs(float(l_t) - float(l_jit)) <= max(1.5 * lspread,
                                                 1e-5 * float(l_jit)), (
        float(l_t), float(l_jit), float(l_eager))
