"""The port's main path as a whole against the JAX package: synthetic
frames -> preprocess_frame -> init_tracker -> 4 x track_step, on
tiny_scene with the slice's solver settings (pairs_fused CG, tuple-Gram
assembly, bf16 pair sums, deferred LM).

Each side runs its own preprocessing from the same numpy frames.  The
tracked state is chaotic at the float32 rounding level: the LM's accept /
reject sequence and the fusion's merge gates react to single ULPs, and the
final costs sit at the noise floor (sums of squared residuals of a few
micrometres).  The JAX package's own jit and eager runs of this sequence
differ by up to 10% in lm_cost and by 14 of ~3000 surfels, so those are
the scales of the tolerances below.
"""

import jax
import numpy as np
import pytest
import torch

from torch_helpers import port_config, port_intr, scene, slice_config

from super_tpu.core.tracker import init_tracker, track_step
from super_tpu_torch.convert import to_numpy
from super_tpu_torch.core import tracker as ttrack
from super_tpu_torch.core.preprocess import preprocess_frame
from super_tpu_torch.kernels import gram as tgram
from super_tpu_torch.kernels import pcg as tpcg

FRAMES = 4


@pytest.fixture(scope="module")
def runs():
    cfg = slice_config(gram_sum_dtype="bf16")
    intr, seq, frames = scene(FRAMES + 1, cfg)
    state = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    step = jax.jit(lambda s, f: track_step(cfg, intr, s, f))
    want = []
    for t in range(1, FRAMES + 1):
        state, outs = step(state, frames[t])
        want.append(jax.tree.map(np.asarray, outs))
    want_nodes = np.asarray(state.graph.points)

    pcfg, pintr = port_config(cfg), port_intr(intr)
    colors = np.ascontiguousarray(seq.colors.transpose(0, 3, 1, 2))
    pframes = [preprocess_frame(pcfg, pintr, seq.depths[t], colors[t],
                                float(t), device="cpu")
               for t in range(FRAMES + 1)]
    launches = (tpcg.pairs_cg.launches, tgram.tuple_gram.launches)
    pstate = ttrack.init_tracker(pcfg, pframes[0])
    got = []
    for t in range(1, FRAMES + 1):
        pstate, pouts = ttrack.track_step(pcfg, pintr, pstate, pframes[t])
        got.append(to_numpy(pouts))
    assert launches == (tpcg.pairs_cg.launches, tgram.tuple_gram.launches), \
        "CPU tensors must take the plain versions"
    return want, got, want_nodes, pstate.graph.points.numpy()


@pytest.mark.parametrize("t", range(FRAMES))
def test_track_frame_outputs(runs, t):
    want, got = runs[0][t], runs[1][t]
    assert np.isfinite(got.lm_cost) and got.lm_cost > 0
    np.testing.assert_allclose(got.lm_cost, want.lm_cost, rtol=0.15)
    # The damping walks the ladder u0 * v^k; where on it a frame ends
    # depends on the accept/reject sequence (see above), so hold the port
    # to the ladder itself.
    k = np.log(float(got.lm_damping) / 10.0) / np.log(7.5)
    assert abs(k - round(k)) < 1e-3, k
    n_want = int(want.num_surfels)
    assert abs(int(got.num_surfels) - n_want) <= 0.01 * n_want
    assert int(got.num_nodes) == int(want.num_nodes)
    # Capacity counters are integers with a margin of many units here:
    # exactly equal.
    for name in ("tuple_overflow", "pair_overflow", "proj_overflow",
                 "add_overflow", "free_exhausted", "dup_skipped"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name


def test_track_node_positions(runs):
    """After 4 frames the ED nodes sit where the JAX package puts them, to
    0.1 mm (~0.1 px at 0.55 m): the chaotic part of the state stays small."""
    want_nodes, got_nodes = runs[2], runs[3]
    assert np.max(np.abs(want_nodes - got_nodes)) < 1e-4
