"""A 10-step graph_fit with the optical-flow correspondence term
(``sf_corr``) and a per-frame flow, the port's against the JAX package's,
on tests/test_torch_corr_flow.py's scene (tests/torch_helpers.py:
corr_flow_scene): the bench's semantic configuration with sf_corr on the
tiny semantic scene, the flow one deterministic function of the two
images in each package."""

import jax
import numpy as np
import pytest
import torch

from torch_helpers import CORR_J_MODELS as J_MODELS, \
    CORR_T_MODELS as T_MODELS, corr_flow_scene, port_frame

from super_tpu.core import optimizer as jopt
from super_tpu_torch.core import optimizer as topt


@pytest.fixture(scope="module")
def corr_scene():
    return corr_flow_scene(kinds=("point-point",))


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
