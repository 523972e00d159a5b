"""Fusion's ``proj_map_mode="scatter"`` in the port: the layer maps peeled
by scatter-max and scatter-min against the JAX package's scatter maps and
the port's sort maps (exactly), the ties and overflow of
tests/test_fusion.py, and fuse_frame in scatter mode against the JAX
package's and against the port's sort mode on a crowded map."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fusion import _compare_surfels, _crowded
from torch_helpers import close, port_config, port_frame, port_intr, \
    port_state, scene, slice_config, to_np

from super_tpu.core import fusion as jfus
from super_tpu.core.tracker import init_tracker
from super_tpu_torch import convert
from super_tpu_torch.core import fusion as tfus
from super_tpu_torch.core.state import SurfelState


@pytest.fixture(scope="module")
def crowded():
    """The tiny scene's frame-0 state crowded to up to 6 surfels a pixel
    (test_torch_fusion.py's map), and frame 1."""
    cfg = slice_config()
    intr, _, frames = scene(2, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    return cfg, intr, frames, _crowded(cfg, st)


def _maps(cfg, intr, surfels, mode):
    """(JAX maps, port maps) of ``surfels`` in ``mode``: (proj_id,
    sf_layer, pix) each."""
    c = cfg.replace(proj_map_mode=mode)
    pid, _, pix, lay = jfus.build_projection_maps(c, intr, surfels)
    ps = convert._named(SurfelState, to_np(surfels), "cpu")
    return (pid, lay, pix), tfus.build_projection_maps(
        port_config(c), port_intr(intr), ps)


def test_scatter_maps_match_jax_and_sort(crowded):
    """Layers to depth 4 on pixels with up to 6 surfels: the port's scatter
    maps equal the JAX package's scatter maps and the port's sort maps,
    every entry (layers, the overflow's layer L, the pixels)."""
    cfg, intr, _, st = crowded
    (jpid, jlay, jpix), (pid, lay, pix) = _maps(cfg, intr, st.surfels,
                                                "scatter")
    _, (spid, slay, spix) = _maps(cfg, intr, st.surfels, "sort")
    assert int(np.sum(np.asarray(jlay) == cfg.capacity.proj_map_depth)) > 0
    for want, got, name in ((jpid, pid, "proj_id"), (jlay, lay, "sf_layer"),
                            (jpix, pix, "pix"), (spid, pid, "vs sort"),
                            (slay, lay, "layer vs sort"),
                            (spix, pix, "pix vs sort")):
        close(np.asarray(want).astype(np.int64),
              got.numpy().astype(np.int64), atol=0, name=name)


def test_scatter_maps_ties_and_overflow():
    """tests/test_fusion.py's collisions: four surfels on one pixel with
    confidences 1, 2, 2, 0.5 at depth 2: slot 1 wins layer 0 (the tie by
    the lower slot id), slot 2 layer 1, slots 0 and 3 overflow."""
    from helpers import tiny_scene

    cfg, intr, seq, frames = tiny_scene(num_frames=1, h=24, w=32, step=8)
    cfg = cfg.replace(capacity=dataclasses.replace(cfg.capacity,
                                                   proj_map_depth=2))
    s = init_tracker(cfg, frames[0]).surfels
    pts = s.points.at[:, 0:4].set(jnp.broadcast_to(s.points[:, 5:6], (3, 4)))
    confs = s.confs.at[0:4].set(jnp.asarray([1.0, 2.0, 2.0, 0.5],
                                            s.confs.dtype))
    active = jnp.zeros_like(s.active).at[0:4].set(True)
    s = s._replace(points=pts, confs=confs, active=active)
    (jpid, jlay, _), (pid, lay, _) = _maps(cfg, intr, s, "scatter")
    close(np.asarray(jpid).astype(np.int64), pid, atol=0, name="proj_id")
    close(np.asarray(jlay).astype(np.int64), lay, atol=0, name="sf_layer")
    coord = int(torch.nonzero(pid[0] >= 0)[0, 0])
    assert (int(pid[0, coord]), int(pid[1, coord])) == (1, 2)
    assert lay[:4].tolist() == [2, 0, 1, 2]


def test_fuse_frame_scatter_mode(crowded):
    """fuse_frame with the scatter maps on the crowded map (layer overflow,
    duplicate merges, adds): every counter and the remap equal the JAX
    package's scatter mode and the port's sort mode, the surfels within
    test_torch_fusion.py's tolerances of the JAX package's and bitwise
    equal to the port's sort mode."""
    cfg, intr, frames, st = crowded
    cfg = cfg.replace(proj_map_mode="scatter")
    s_j, remap_j, diag_j = jax.jit(
        lambda s, g, f: jfus.fuse_frame(cfg, intr, s, g, f))(
        st.surfels, st.graph, frames[1])
    ps, pf, pi = port_state(st), port_frame(frames[1]), port_intr(intr)
    s_t, remap_t, diag_t = tfus.fuse_frame(port_config(cfg), pi, ps.surfels,
                                           ps.graph, pf)
    s_s, remap_s, diag_s = tfus.fuse_frame(
        port_config(cfg.replace(proj_map_mode="sort")), pi, ps.surfels,
        ps.graph, pf)
    assert int(diag_j.proj_overflow) > 0
    for name in diag_j._fields:
        close(getattr(diag_j, name), getattr(diag_t, name), atol=0, name=name)
        assert torch.equal(getattr(diag_s, name), getattr(diag_t, name))
    close(remap_j, remap_t, atol=0, name="remap")
    assert torch.equal(remap_s, remap_t)
    _compare_surfels(s_j, s_t)
    for a, b in zip(s_s, s_t):
        assert torch.equal(a, b)
