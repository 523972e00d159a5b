"""The optical-flow correspondence term (``sf_corr``) of the port's autograd
fit against the JAX package's, on the tiny semantic scene of
tests/test_torch_autograd.py with the root bench's semantic configuration:
the corr face (point-point and point-plane; a per-frame flow anchored at
the source projections and the flow of the current soft render) with its
gradient and the context's flow plumbing (the 10-step graph_fit with a
per-frame flow is in test_torch_corr_flow_fit.py).  The flow comes from
one deterministic function of the two images, written for each package
(tests/torch_helpers.py:corr_jflow, corr_tflow), so that both fits see
the same flow from the same images; RAFT itself is held to the flax model
in test_torch_raft_flow.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, corr_flow_scene, corr_jflow as _jflow, \
    corr_tflow as _tflow

from super_tpu.core import optimizer as jopt
from super_tpu_torch.core import optimizer as topt


@pytest.fixture(scope="module")
def corr_scene():
    return corr_flow_scene()


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
