"""Parity of the semantic slice's building blocks with the JAX package:
the divergences, the extended z-bank and the image bank with their
samplers (values and gradients in the query coordinates, the image bank
with its detached rows), the index-map sampler, SSIM, the soft splat
(value and gradients in points and colours), the blended warp and the
semantic anchor weights.  Inputs are made from a seed with numpy, or taken
from the tiny scene with its two-class segmentations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, port_config, port_frame, port_intr, \
    port_state, semantic_config, semantic_scene

from super_tpu.core import anchoring as janc
from super_tpu.core.semantic import build_semantic_extras
from super_tpu.core.tracker import init_tracker
from super_tpu.geometry import divergence as jdiv
from super_tpu.geometry.quaternion import blend_warp as j_blend
from super_tpu.ops import bilinear as jbil
from super_tpu.ops.ssim import ssim as j_ssim
from super_tpu.render.splat import render_soft as j_render
from super_tpu_torch.core import anchoring as tanc
from super_tpu_torch.geometry import divergence as tdiv
from super_tpu_torch.geometry.quaternion import blend_warp as t_blend
from super_tpu_torch.ops import bilinear as tbil
from super_tpu_torch.ops.ssim import ssim as t_ssim
from super_tpu_torch.render.splat import render_soft as t_render


@pytest.fixture(scope="module")
def sem():
    cfg = semantic_config()
    intr, seq, frames = semantic_scene(2, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    return cfg, intr, frames, st


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _queries(rng, n, h, w, margin=2.0):
    """(v, u) f32 queries over the image and a margin beyond it."""
    v = rng.uniform(-margin, h - 1 + margin, n).astype(np.float32)
    u = rng.uniform(-margin, w - 1 + margin, n).astype(np.float32)
    return v, u


def _vjp_both(jfn, tfn, v, u, cots):
    """Values and the gradient in (v, u) of sum(cot * output) over the
    outputs, on both sides: ((j_outs, j_gv, j_gu), (t_outs, t_gv, t_gu))."""
    j_outs, vjp = jax.vjp(jfn, jnp.asarray(v), jnp.asarray(u))
    j_gv, j_gu = vjp(tuple(jnp.asarray(c) for c in cots))
    tv, tu = _t(v, True), _t(u, True)
    t_outs = tfn(tv, tu)
    sum(torch.sum(o * _t(c)) for o, c in zip(t_outs, cots)).backward()
    return (j_outs, j_gv, j_gu), (t_outs, tv.grad, tu.grad)


def _grad_close(want, got, rel, name):
    """Gradients at ``rel`` of the largest entry."""
    scale = float(np.max(np.abs(np.asarray(want))))
    close(want, got, atol=rel * scale, name=name)


def test_divergences():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 500, 3)).astype(np.float32)
    p, q = (np.exp(x) / np.exp(x).sum(-1, keepdims=True) for x in logits)
    q[:10] = p[:10]                       # equal rows: JSD 0
    p[10:20, 0] = 0.0                     # zero mass: the eps placement
    # f32 logs of ratios near 1: 1e-6 absolute on values of order 0.1.
    close(jdiv.kld(jnp.asarray(p), jnp.asarray(q)),
          tdiv.kld(_t(p), _t(q)), atol=1e-6, name="kld")
    close(jdiv.jsd(jnp.asarray(p), jnp.asarray(q)),
          tdiv.jsd(_t(p), _t(q)), atol=1e-6, name="jsd")


def test_corner_bank_zx(sem):
    cfg, intr, frames, _ = sem
    h, w = cfg.height, cfg.width
    fr = frames[1]
    bank_j = jbil.build_corner_bank_zx(fr.points, fr.norms, fr.seg_conf,
                                       fr.index_map(h, w))
    pf = port_frame(fr)
    bank_t = tbil.build_corner_bank_zx(pf.points, pf.norms, pf.seg_conf,
                                       pf.index_map(h, w))
    close(bank_j, bank_t, atol=0, name="bank")      # copies, exact

    rng = np.random.default_rng(1)
    v, u = _queries(rng, 3000, h, w)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((3, 3000), (3, 3000), (2, 3000))]
    pin = port_intr(intr)
    (jo, jgv, jgu), (to, tgv, tgu) = _vjp_both(
        lambda a, b: jbil.bilinear_sample_bank_zx_fm(bank_j, 2, intr, h, w,
                                                     a, b)[:3],
        lambda a, b: tbil.bilinear_sample_bank_zx_fm(bank_t, 2, pin, h, w,
                                                     a, b)[:3],
        v, u, cots)
    ok_j = jbil.bilinear_sample_bank_zx_fm(bank_j, 2, intr, h, w,
                                           jnp.asarray(v), jnp.asarray(u))[3]
    ok_t = tbil.bilinear_sample_bank_zx_fm(bank_t, 2, pin, h, w, _t(v),
                                           _t(u))[3]
    close(ok_j, ok_t, atol=0, name="ok")
    assert 0.3 < float(np.mean(ok_j)) < 1.0
    # Four-corner blends of f32 values (points ~0.5 m): 1e-6; gradients
    # at 1e-5 of the largest (depth edges make them large).
    for name, a, b in zip(("o", "n", "conf"), jo, to):
        close(a, b, atol=1e-6, name=name)
    _grad_close(jgv, tgv, 1e-5, "d/dv")
    _grad_close(jgu, tgu, 1e-5, "d/du")


@pytest.mark.parametrize("stop_grad_rows", [None, (0, 2)])
def test_image_bank(sem, stop_grad_rows):
    cfg, _, frames, _ = sem
    h, w = cfg.height, cfg.width
    fr = frames[1]
    extras = build_semantic_extras(cfg, fr.seg.reshape(h, w),
                                   fr.seg_conf.reshape(-1, h, w),
                                   fr.color_image)
    image = np.concatenate([np.asarray(extras.seg_conf_image),
                            np.asarray(extras.edge_dt)])     # (4, H, W)
    bank_j = jbil.build_corner_bank_image(jnp.asarray(image))
    bank_t = tbil.build_corner_bank_image(_t(image))
    close(bank_j, bank_t, atol=0, name="bank")

    rng = np.random.default_rng(2)
    # floor(v, u) in the image: where the bank is exact.
    v = rng.uniform(0, h - 1, 3000).astype(np.float32)
    u = rng.uniform(0, w - 1, 3000).astype(np.float32)
    cots = [rng.normal(size=(4, 3000)).astype(np.float32)]
    (jo, jgv, jgu), (to, tgv, tgu) = _vjp_both(
        lambda a, b: (jbil.bilinear_sample_bank_image(
            bank_j, 4, h, w, a, b, stop_grad_rows=stop_grad_rows)[0],),
        lambda a, b: (tbil.bilinear_sample_bank_image(
            bank_t, 4, h, w, a, b, stop_grad_rows=stop_grad_rows)[0],),
        v, u, cots)
    # Distances to 30 px: 1e-5 absolute; gradients at 1e-5 of the largest.
    close(jo[0], to[0], atol=1e-5, name="values")
    _grad_close(jgv, tgv, 1e-5, "d/dv")
    _grad_close(jgu, tgu, 1e-5, "d/du")


def test_sample_indexed(sem):
    cfg, _, frames, _ = sem
    h, w = cfg.height, cfg.width
    fr = frames[1]
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(3, h * w)).astype(np.float32)
    imap_j = fr.index_map(h, w)
    imap_t = port_frame(fr).index_map(h, w)
    v, u = _queries(rng, 3000, h, w)
    cots = [rng.normal(size=(3000, 3)).astype(np.float32)]
    (jo, jgv, jgu), (to, tgv, tgu) = _vjp_both(
        lambda a, b: (jbil.bilinear_sample_indexed(jnp.asarray(feats),
                                                   imap_j, a, b)[0],),
        lambda a, b: (tbil.bilinear_sample_indexed(_t(feats), imap_t, a,
                                                   b)[0],),
        v, u, cots)
    valid_j = jbil.bilinear_sample_indexed(jnp.asarray(feats), imap_j,
                                           jnp.asarray(v), jnp.asarray(u))[1]
    valid_t = tbil.bilinear_sample_indexed(_t(feats), imap_t, _t(v),
                                           _t(u))[1]
    close(valid_j, valid_t, atol=0, name="valid")
    close(jo[0], to[0], atol=1e-6, name="values")
    _grad_close(jgv, tgv, 1e-5, "d/dv")
    _grad_close(jgu, tgu, 1e-5, "d/du")


def test_ssim():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (3, 30, 40)).astype(np.float32)
    y = np.clip(x + 0.2 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    for k in (3, 11):
        j_out, vjp = jax.vjp(lambda a: j_ssim(a, jnp.asarray(y), kernel=k),
                             jnp.asarray(x))
        tx = _t(x, True)
        t_out = t_ssim(tx, _t(y), kernel=k)
        torch.sum(t_out * _t(cot)).backward()
        # Window means of f32 products: 1e-6 on values in [0, 1].
        close(j_out, t_out, atol=1e-6, name=f"ssim k={k}")
        _grad_close(vjp(jnp.asarray(cot))[0], tx.grad, 1e-5, f"grad k={k}")


@pytest.mark.parametrize("points", ["surfels", "moved"])
def test_render_soft(sem, points):
    """On the frame-0 surfels (every one on a pixel centre: the splat's
    kinks) and on the same moved off the grid."""
    cfg, intr, _, st = sem
    h, w = cfg.height, cfg.width
    rng = np.random.default_rng(5)
    pts = np.asarray(st.surfels.points)
    mask = np.asarray(st.surfels.active)
    if points == "moved":
        pts = (pts + 2e-3 * rng.normal(size=pts.shape)).astype(np.float32)
    cols = np.asarray(st.surfels.colors)
    cot = rng.normal(size=(3, h, w)).astype(np.float32)
    j_img, vjp = jax.vjp(lambda p, c: j_render(p, c, jnp.asarray(mask), intr,
                                               h, w),
                         jnp.asarray(pts), jnp.asarray(cols))
    j_gp, j_gc = vjp(jnp.asarray(cot))
    tp, tc = _t(pts, True), _t(cols, True)
    t_img = t_render(tp, tc, _t(mask), port_intr(intr), h, w)
    torch.sum(t_img * _t(cot)).backward()
    # Weight-normalised blends of f32 colours: 1e-6; gradients at 1e-5 of
    # the largest entry.
    close(j_img, t_img, atol=1e-6, name="image")
    _grad_close(j_gp, tp.grad, 1e-5, "d/dpoints")
    _grad_close(j_gc, tc.grad, 1e-5, "d/dcolors")


def test_blend_warp():
    rng = np.random.default_rng(6)
    d = rng.normal(size=(200, 4, 3)).astype(np.float32)
    g = rng.normal(size=(200, 4, 3)).astype(np.float32)
    beta = np.concatenate([np.ones((200, 4, 1)), np.zeros((200, 4, 6))], -1)
    beta = (beta + 0.05 * rng.normal(size=beta.shape)).astype(np.float32)
    wgt = rng.dirichlet(np.ones(4), 200).astype(np.float32)
    # Rotations of unit-size vectors, 4 terms: 1e-6.
    close(j_blend(*map(jnp.asarray, (d, g, beta, wgt))),
          t_blend(*map(_t, (d, g, beta, wgt))), atol=1e-6, name="warped")


def test_semantic_anchor_weights(sem):
    """The JSD-blended weights, on the same anchors and distances (the KNN
    itself has near-ties, test_torch_preprocess.py), and their refresh
    with fixed anchors on the frame-0 map."""
    cfg, _, frames, st = sem
    pcfg, ps = port_config(cfg), port_state(st)
    g = st.graph
    rng = np.random.default_rng(7)
    n = 2000
    idx = np.stack([rng.choice(int(np.sum(g.active)), 4, replace=False)
                    for _ in range(n)], axis=1).astype(np.int32)
    dists = rng.uniform(0, 0.05, (4, n)).astype(np.float32)
    dists[3, :100] = np.inf                   # fewer than K neighbours
    radii = np.asarray(g.radii)[idx]
    finite = np.isfinite(dists)
    conf = rng.dirichlet(np.ones(2), n).T.astype(np.float32)
    w_j = janc._anchor_weights(cfg, g, jnp.asarray(idx), jnp.asarray(dists),
                               jnp.asarray(radii), jnp.asarray(finite),
                               jnp.asarray(conf))
    w_t = tanc._anchor_weights(pcfg, ps.graph, _t(idx), _t(dists),
                               _t(radii), _t(finite), _t(conf))
    # Softmax of f32 exp-scores in [0, 1]: 1e-6.
    close(w_j, w_t, atol=1e-6, name="weights")
    s_j = janc.recompute_surfel_weights(cfg, st.surfels, g)
    s_t = tanc.recompute_surfel_weights(pcfg, ps.surfels, ps.graph)
    act = np.asarray(st.surfels.active)
    # Distances from f32 differences (ROADMAP queue 3 on the cancellation):
    # 1e-5 on weights in [0, 1].
    close(np.asarray(s_j.knn_w)[:, act], s_t.knn_w.numpy()[:, act],
          atol=1e-5, name="refreshed")
