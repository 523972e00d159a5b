"""Parity of the port's LM solve with the associations it added to the
per-frame one: ``"per_iteration"`` (the moving target), ``"per_iteration_
frozen"`` (associate at every candidate, frozen-target rows) and no data
term (``losses.sf_point_plane=False``), under the deferred and classic
schedules, against the JAX package's ``lm_solve`` on frame 1."""

import dataclasses
import math

import jax
import pytest

from torch_helpers import close, port_config, port_frame, port_intr, \
    port_state, scene, slice_config

from super_tpu.core import lm as jlm
from super_tpu.core import losses as jloss
from super_tpu.core.tracker import init_tracker
from super_tpu_torch.core import lm as tlm
from super_tpu_torch.core import losses as tloss


@pytest.fixture(scope="module")
def frame1():
    cfg = slice_config()
    intr, _, frames = scene(2, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    return cfg, intr, frames, st


def _config(cfg, mode, schedule):
    if mode == "no_point_plane":
        # The JAX package's pair form fails without the data term (its
        # block-layout transpose meets the (P, 49) pair table,
        # losses.py:1378); the dense Cholesky solve runs it.
        cfg = cfg.replace(losses=dataclasses.replace(
            cfg.losses, sf_point_plane=False))
        return cfg.replace(solver=dataclasses.replace(
            cfg.solver, association="per_iteration", lm_schedule=schedule,
            linear_solver="cholesky"))
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, association=mode, lm_schedule=schedule))


def _solve(frame1, cfg, jit=False):
    _, intr, frames, st = frame1
    ctx = jax.jit(lambda s, g, f: jloss.prepare_lm(cfg, s, g, f))(
        st.surfels, st.graph, frames[1])
    # Eager, as test_torch_lm.py runs it (and jit for the reference's own
    # spread).
    res = (jax.jit(lambda c: jlm.lm_solve(cfg, c, intr))(ctx) if jit
           else jlm.lm_solve(cfg, ctx, intr))
    ps = port_state(st)
    pcfg = port_config(cfg)
    pctx = tloss.prepare_lm(pcfg, ps.surfels, ps.graph, port_frame(frames[1]))
    return res, tlm.lm_solve(pcfg, pctx, port_intr(intr))


def _ladder(u):
    """The damping's rung k on the ladder u0 * v^k (u0 10, v 7.5)."""
    return round(math.log(float(u) / 10.0) / math.log(7.5))


@pytest.mark.parametrize("schedule", ["deferred", "classic"])
@pytest.mark.parametrize("mode", ["per_iteration_frozen", "no_point_plane"])
def test_lm_solve(frame1, mode, schedule):
    res, pres = _solve(frame1, _config(frame1[0], mode, schedule))
    # test_torch_lm.py's tolerances: ten LM trips of f32 assembly and
    # 32-iteration CG agree to 1e-5 on beta, 1e-3 relative on the final
    # cost, and follow the same accept/reject sequence (damping 1e-6
    # relative).
    close(res.beta, pres.beta, atol=1e-5, name="beta")
    close(res.cost, pres.cost, atol=0, rtol=1e-3, name="cost")
    close(res.final_damping, pres.final_damping, atol=0, rtol=1e-6,
          name="final_damping")


@pytest.fixture(scope="module")
def per_iteration_ref(frame1):
    """The JAX package's four solves of frame 1 with the moving target:
    each schedule eager and under jit, and the port's."""
    refs, ports = {}, {}
    for schedule in ("deferred", "classic"):
        cfg = _config(frame1[0], "per_iteration", schedule)
        refs[schedule], ports[schedule] = _solve(frame1, cfg)
        refs[schedule + "_jit"] = _solve(frame1, cfg, jit=True)[0]
    return refs, ports


@pytest.mark.parametrize("schedule", ["deferred", "classic"])
def test_lm_solve_per_iteration(per_iteration_ref, schedule):
    """The moving target is chaotic at f32 rounding: each trip re-samples
    the target at the candidate, and a sample within one ULP of a pixel
    boundary switches its bilinear corners and the sign of its sampling
    gradient.  The JAX package's own jit and eager solves of this frame
    differ in beta by the order of 1e-3 and in the final cost (a sum of
    squared micrometre residuals, ~1e-7) several-fold, and its deferred
    and classic schedules end apart (equal in exact arithmetic).  So the
    port is held to what that spread leaves: beta within 5e-3 of the eager
    reference of its schedule, the final cost no worse than twice the
    worst of the reference's four runs (this fixture's), and the
    damping at most one accept/reject flip (two rungs of its ladder) from
    the eager reference's, as test_torch_solvers.py holds its Cholesky
    schedules.  The assembly itself is held at 1e-5
    (test_torch_moving.py)."""
    refs, ports = per_iteration_ref
    res, pres = refs[schedule], ports[schedule]
    close(res.beta, pres.beta, atol=5e-3, name="beta")
    worst = max(float(r.cost) for r in refs.values())
    assert float(pres.cost) <= 2.0 * worst, (float(pres.cost), worst)
    assert abs(_ladder(res.final_damping) -
               _ladder(pres.final_damping)) <= 2
