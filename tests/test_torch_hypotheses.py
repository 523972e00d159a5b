"""``lm_hypotheses`` > 1 in the port against the JAX package's
``_lm_solve_hypotheses``: one assembly a trip at the accepted point, H
cold-started solves on the damping ladder u v^-(H-1) .. u, the least
candidate cost taken.  Each of the four solvers at H = 2 and 3, on frame 3
solved from the frame-0 model (tests/test_lm.py's hypotheses scene); and
on the same frame the LM solve over the scatter assembly and the block
expansion."""

import dataclasses

import jax
import numpy as np
import pytest

from torch_helpers import close, port_config, port_frame, port_intr, \
    port_state, scene, slice_config

from super_tpu.core import lm as jlm
from super_tpu.core import losses as jloss
from super_tpu.core.tracker import init_tracker
from super_tpu_torch.core import lm as tlm
from super_tpu_torch.core import losses as tloss
from super_tpu_torch.kernels import pcg as tpcg

SOLVERS = ("pairs_fused", "cholesky", "pcg", "pcg_pallas")


@pytest.fixture(scope="module")
def frame3():
    cfg = slice_config()
    intr, _, frames = scene(4, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    return dict(cfg=cfg, intr=intr, frame=frames[3], st=st,
                ps=port_state(st), pf=port_frame(frames[3]),
                pi=port_intr(intr), runs={})


def _solve(f, solver, hyp, schedule="deferred"):
    """(JAX LMResult or None, port LMResult) for one configuration; the
    JAX side only for H > 1, eagerly, as the port runs."""
    key = (solver, hyp, schedule)
    if key not in f["runs"]:
        cfg = f["cfg"].replace(solver=dataclasses.replace(
            f["cfg"].solver, linear_solver=solver, lm_hypotheses=hyp,
            lm_schedule=schedule))
        want = None
        if hyp > 1:
            ctx = jloss.prepare_lm(cfg, f["st"].surfels, f["st"].graph,
                                   f["frame"])
            want = jlm.lm_solve(cfg, ctx, f["intr"])
        pcfg = port_config(cfg)
        pctx = tloss.prepare_lm(pcfg, f["ps"].surfels, f["ps"].graph,
                                f["pf"])
        f["runs"][key] = (want, tlm.lm_solve(pcfg, pctx, f["pi"]))
    return f["runs"][key]


def _rung(u):
    """k with u = 10 * 7.5^k: every damping stays on the ladder."""
    k = np.log(float(u) / 10.0) / np.log(7.5)
    assert abs(k - round(k)) < 1e-3, k
    return round(k)


@pytest.mark.parametrize("hyp", [2, 3])
@pytest.mark.parametrize("solver", SOLVERS)
def test_hypotheses_match_jax(frame3, solver, hyp):
    """The accepted beta and cost within the JAX package's own spread on
    this solve: its jit and eager runs of H = 2 end 1.3e-4 apart on beta
    and 1.9e-3 on the cost (measured with cholesky, pcg and pairs_fused),
    since the last trips take the argmin of H costs equal to 1e-7, which
    the rounding decides.  So beta to 2e-4, the cost to 3e-3 (the port
    measured 7e-5 and 1e-4 from the eager run), the damping on the ladder
    (its rung follows the rounding-decided choices)."""
    want, got = _solve(frame3, solver, hyp)
    assert np.isfinite(float(got.cost))
    close(want.beta, got.beta, atol=2e-4, name="beta")
    close(want.cost, got.cost, atol=0, rtol=3e-3, name="cost")
    _rung(got.final_damping)


@pytest.mark.parametrize("hyp", [2, 3])
@pytest.mark.parametrize("solver", SOLVERS)
def test_hypotheses_no_worse_than_one(frame3, solver, hyp):
    """tests/test_lm.py's claims on the port: the H candidates include the
    single-hypothesis one, so the final cost is no worse than the classic
    schedule's with Cholesky (to 1e-3, the f32 noise at convergence), and
    than H = 1's with the inexact CG solves (to 1e-2, their inexactness)."""
    _, got = _solve(frame3, solver, hyp)
    if solver == "cholesky":
        _, ref = _solve(frame3, solver, 1, schedule="classic")
        tol = 1e-3
    else:
        _, ref = _solve(frame3, solver, 1)
        tol = 1e-2
    assert float(got.cost) <= float(ref.cost) * (1 + tol), (
        float(got.cost), float(ref.cost))


@pytest.mark.parametrize("solver,kw", [
    ("pcg_pallas", dict(assembly_mode="scatter")),
    ("cholesky", dict(assembly_expand="blocks"))])
def test_block_forms_lm_solve(frame3, solver, kw):
    """The LM solve (deferred, H = 1) on the scatter assembly under
    pcg_pallas and on the block expansion under cholesky, against the JAX
    package's, eagerly as the port runs: test_torch_solvers.py::test_lm_solve_dense's tolerances (beta
    1e-5, the cost 1e-3, the damping on the ladder within one flip)."""
    f = frame3
    cfg = f["cfg"].replace(solver=dataclasses.replace(
        f["cfg"].solver, linear_solver=solver, **kw))
    ctx = jloss.prepare_lm(cfg, f["st"].surfels, f["st"].graph, f["frame"])
    want = jlm.lm_solve(cfg, ctx, f["intr"])
    pcfg = port_config(cfg)
    pctx = tloss.prepare_lm(pcfg, f["ps"].surfels, f["ps"].graph, f["pf"])
    got = tlm.lm_solve(pcfg, pctx, f["pi"])
    close(want.beta, got.beta, atol=1e-5, name="beta")
    close(want.cost, got.cost, atol=0, rtol=1e-3, name="cost")
    assert abs(_rung(want.final_damping) - _rung(got.final_damping)) <= 2


def test_hypotheses_cpu_launches_nothing(frame3):
    """H solves of K1 and K3 a trip on the card; on CPU tensors the plain
    versions, no launch."""
    f = frame3
    before = (tpcg.pairs_cg.launches, tpcg.dense_cg.launches)
    for solver in ("pairs_fused", "pcg_pallas"):
        cfg = port_config(f["cfg"].replace(solver=dataclasses.replace(
            f["cfg"].solver, linear_solver=solver, lm_hypotheses=2,
            num_iterations=2)))
        ctx = tloss.prepare_lm(cfg, f["ps"].surfels, f["ps"].graph, f["pf"])
        assert np.isfinite(float(tlm.lm_solve(cfg, ctx, f["pi"]).cost))
    assert before == (tpcg.pairs_cg.launches, tpcg.dense_cg.launches)
