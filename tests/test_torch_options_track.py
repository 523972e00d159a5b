"""Tiny tracks with the LM step's options and fusion's scatter maps, the
port against the JAX package, as tests/test_torch_solvers.py holds the "pcg_pallas" track:
3 frames after frame 0 with damping hypotheses (H = 3 under pairs_fused,
H = 2 under pcg_pallas), the bf16 dense matrix and PCG, the scatter
assembly, the block expansion, and fusion's scatter projection maps."""

import dataclasses

import jax
import numpy as np
import pytest

from torch_helpers import port_config, port_intr, scene, slice_config

from super_tpu.core.tracker import init_tracker, track_step
from super_tpu_torch.convert import to_numpy
from super_tpu_torch.core import tracker as ttrack
from super_tpu_torch.core.preprocess import preprocess_frame

FRAMES = 3
# (solver fields, config fields)
OPTIONS = {
    "hypotheses": (dict(lm_hypotheses=3), None),
    "hypotheses_dense": (dict(linear_solver="pcg_pallas", lm_hypotheses=2),
                         None),
    "bf16_pcg": (dict(linear_solver="pcg", jtj_dtype="bf16"), None),
    "scatter": (dict(assembly_mode="scatter", linear_solver="cholesky"),
                None),
    "expand_blocks": (dict(assembly_expand="scatter",
                           linear_solver="cholesky"), None),
    "proj_map_scatter": ({}, dict(proj_map_mode="scatter")),
}


def option_tracks(option_fields, config=None):
    """(JAX outputs, port outputs, JAX nodes, port nodes) of a FRAMES-frame
    tiny track of slice_config() with ``option_fields`` in its solver (and
    ``config`` fields)."""
    cfg = slice_config(gram_sum_dtype="bf16")
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                 **option_fields),
                      **(config or {}))
    intr, seq, frames = scene(FRAMES + 1, cfg)
    state = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    step = jax.jit(lambda s, f: track_step(cfg, intr, s, f))
    want = []
    for t in range(1, FRAMES + 1):
        state, outs = step(state, frames[t])
        want.append(jax.tree.map(np.asarray, outs))
    pcfg, pintr = port_config(cfg), port_intr(intr)
    colors = np.ascontiguousarray(seq.colors.transpose(0, 3, 1, 2))
    pframes = [preprocess_frame(pcfg, pintr, seq.depths[t], colors[t],
                                float(t), device="cpu")
               for t in range(FRAMES + 1)]
    pstate = ttrack.init_tracker(pcfg, pframes[0])
    got = []
    for t in range(1, FRAMES + 1):
        pstate, pouts = ttrack.track_step(pcfg, pintr, pstate, pframes[t])
        got.append(to_numpy(pouts))
    return want, got, np.asarray(state.graph.points), \
        pstate.graph.points.numpy()


def check_track(runs, node_atol=1e-4):
    """tests/test_torch_solvers.py's track tolerances (test_torch_track.py's
    docstring gives their scales): the frame costs to 15%, surfel counts to
    1%, node counts and every overflow counter equal, and the node
    positions to ``node_atol``."""
    want, got, nodes_j, nodes_t = runs
    for w, g in zip(want, got):
        assert np.isfinite(g.lm_cost) and g.lm_cost > 0
        np.testing.assert_allclose(g.lm_cost, w.lm_cost, rtol=0.15)
        k = np.log(float(g.lm_damping) / 10.0) / np.log(7.5)
        assert abs(k - round(k)) < 1e-3
        n_want = int(w.num_surfels)
        assert abs(int(g.num_surfels) - n_want) <= 0.01 * n_want
        assert int(g.num_nodes) == int(w.num_nodes)
        for name in ("tuple_overflow", "pair_overflow", "proj_overflow",
                     "add_overflow", "free_exhausted", "dup_skipped"):
            assert int(getattr(g, name)) == int(getattr(w, name)), name
    assert np.max(np.abs(nodes_j - nodes_t)) < node_atol


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_track(option):
    check_track(option_tracks(*OPTIONS[option]))
