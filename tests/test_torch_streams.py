"""The port's stream batch (super_tpu_torch/parallel/sharded.py:
make_batched_step) against its single-stream step and against the JAX
package's ``jit(vmap(step))``, and the stacked conversions (convert.py,
utils/tree.py).

Three streams: three time windows of one generated tiny sequence (the
generator's seed varies only the tracked pixels, not the scene), each
window's frames timed from 0, on the port's main-path config.  The batch
loops over the streams, so each stream is bitwise the single-stream step
on the same inputs.  Against the JAX package's batched step each stream is
held to tests/torch_helpers.py:check_track's bands (test_torch_track.py
gives their scales: the tracked state is chaotic at f32 rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import check_track, port_config, port_intr, same_bits, \
    slice_config

from super_tpu.core.preprocess import preprocess_frame as jax_preprocess
from super_tpu.core.tracker import init_tracker as jax_init
from super_tpu.data.synthetic import default_intrinsics, generate
from super_tpu.parallel.sharded import make_batched_step as jax_batched
from super_tpu_torch import convert
from super_tpu_torch.core.preprocess import preprocess_frame
from super_tpu_torch.core.tracker import init_tracker, track_step
from super_tpu_torch.parallel.sharded import make_batched_step
from super_tpu_torch.utils.tree import batch_size, leaves, stack, unstack

B, FRAMES = 3, 3         # streams; tracked frames of each after frame 0


@pytest.fixture(scope="module")
def windows():
    cfg = slice_config(gram_sum_dtype="bf16")
    intr = default_intrinsics(cfg.height, cfg.width)
    n = FRAMES + 1
    seq = generate(B * n, cfg.height, cfg.width, intr=intr, seed=0)
    win = lambda a: np.stack([a[b * n:(b + 1) * n]  # noqa: E731
                              for b in range(B)])
    return cfg, intr, win(seq.depths), win(seq.colors)


@pytest.fixture(scope="module")
def jax_run(windows):
    """The JAX package's batched step on the three windows: (per-frame
    outputs, final stacked state), numpy."""
    cfg, intr, depths, colors = windows
    pre = jax.jit(lambda d, c, t: jax_preprocess(cfg, intr, d, c, t))
    frames = [jax.tree.map(lambda *x: jnp.stack(x), *[
        pre(jnp.asarray(depths[b, t]),
            jnp.asarray(colors[b, t].transpose(2, 0, 1)), jnp.float32(t))
        for b in range(B)]) for t in range(FRAMES + 1)]
    states = jax.jit(jax.vmap(lambda f: jax_init(cfg, f)))(frames[0])
    step = jax_batched(cfg, intr)
    outs = []
    for t in range(1, FRAMES + 1):
        states, o = step(states, frames[t])
        outs.append(jax.tree.map(np.asarray, o))
    return outs, jax.tree.map(np.asarray, states)


@pytest.fixture(scope="module")
def port_run(windows):
    """The port's batched step and its single-stream step on the same
    frames: (batched per-frame outputs, batched final state, [(single
    per-frame outputs, single final state)] by stream, frames by stream)."""
    cfg, intr, depths, colors = windows
    pcfg, pintr = port_config(cfg), port_intr(intr)
    frames = [[preprocess_frame(
        pcfg, pintr, depths[b, t], np.ascontiguousarray(
            colors[b, t].transpose(2, 0, 1)), float(t), device="cpu")
        for t in range(FRAMES + 1)] for b in range(B)]
    singles = []
    for b in range(B):
        state = init_tracker(pcfg, frames[b][0])
        outs = []
        for t in range(1, FRAMES + 1):
            state, o = track_step(pcfg, pintr, state, frames[b][t])
            outs.append(o)
        singles.append((outs, state))
    states = stack([init_tracker(pcfg, frames[b][0]) for b in range(B)])
    step = make_batched_step(pcfg, pintr)
    outs = []
    for t in range(1, FRAMES + 1):
        states, o = step(states, stack([frames[b][t] for b in range(B)]))
        outs.append(o)
    return outs, states, singles, frames


@pytest.mark.parametrize("b", range(B))
def test_batched_step_is_the_single_step(port_run, b):
    outs, states, singles, _ = port_run
    s_outs, s_state = singles[b]
    for t in range(FRAMES):
        same_bits(convert.to_numpy(unstack(outs[t])[b]),
                  convert.to_numpy(s_outs[t]))
    same_bits(convert.to_numpy(unstack(states)[b]),
              convert.to_numpy(s_state))


@pytest.mark.parametrize("b", range(B))
def test_batched_step_within_the_jax_batched_steps_bands(jax_run, port_run,
                                                         b):
    j_outs, j_states = jax_run
    outs, states, _, _ = port_run
    pick = lambda o: jax.tree.map(lambda x: x[b], o)  # noqa: E731
    check_track(([pick(o) for o in j_outs],
                 [convert.to_numpy(pick(o)) for o in outs],
                 j_states.graph.points[b],
                 states.graph.points[b].numpy()))


def test_the_streams_differ(port_run):
    points = port_run[1].surfels.points
    for a in range(B):
        for b in range(a + 1, B):
            assert not torch.allclose(points[a], points[b])


def test_batched_step_stacks_its_outputs(port_run):
    outs, states, _, _ = port_run
    assert batch_size(states) == B and batch_size(outs[-1]) == B
    assert outs[-1].lm_cost.shape == (B,)
    assert states.surfels.points.shape[0] == B


def test_batched_step_refuses_mismatched_batches(windows, port_run):
    cfg, intr, _, _ = windows
    states, frames = port_run[1], port_run[3]
    step = make_batched_step(port_config(cfg), port_intr(intr))
    with pytest.raises(ValueError, match="2 frames"):
        step(states, stack([frames[b][1] for b in range(2)]))


def test_convert_stacked_round_trip(jax_run):
    """A stacked JAX state batch into the port's stacked TrackerState and
    back: every leaf equal, in the port's dtypes; each stream of it the
    single-state conversion of that stream."""
    _, j_states = jax_run
    got = convert.tracker_state_from_numpy(j_states, device="cpu")
    assert batch_size(got) == B
    back = convert.to_numpy(got)
    for want, have in zip(jax.tree.leaves(j_states), leaves(back)):
        assert have.shape == want.shape
        np.testing.assert_array_equal(have, want.astype(have.dtype))
        assert have.dtype in (np.float32, np.int32, np.bool_)
    for b in range(B):
        one = convert.tracker_state_from_numpy(
            jax.tree.map(lambda x: x[b], j_states), device="cpu")
        same_bits(convert.to_numpy(unstack(got)[b]), convert.to_numpy(one))


def test_convert_frame_batch(jax_run, windows):
    cfg, intr, depths, colors = windows
    pre = jax.jit(lambda d, c, t: jax_preprocess(cfg, intr, d, c, t))
    frames = jax.tree.map(lambda *x: np.stack(x), *[jax.tree.map(
        np.asarray, pre(jnp.asarray(depths[b, 0]), jnp.asarray(
            colors[b, 0].transpose(2, 0, 1)), jnp.float32(0)))
        for b in range(B)])
    got = convert.frame_from_numpy(frames, device="cpu")
    assert batch_size(got) == B
    same_bits(convert.to_numpy(got), frames)


def test_an_unstacked_state_is_no_batch(jax_run):
    """A single state (its time a scalar) has no common leading axis:
    make_batched_step refuses it."""
    _, j_states = jax_run
    one = convert.tracker_state_from_numpy(
        jax.tree.map(lambda x: x[0], j_states), device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        batch_size(one)


def test_stack_and_unstack_are_inverse(port_run):
    states = port_run[1]
    again = stack(unstack(states))
    for x, y in zip(leaves(again), leaves(states)):
        assert torch.equal(x, y)
