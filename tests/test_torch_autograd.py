"""Parity of the port's autograd fit (core/optimizer.py) with the JAX
package on the tiny scene with its two-class segmentations: the context,
every loss face and the gradient in the deformation, one Adam and one SGD
step against optax, the 10-step fit, the fixed-order gather's gradient,
the semantic workload's configuration and the semantic state's crossing.

Three configurations: ``semantic`` (tests/test_semantic.py's: soft-seg
ICP, rotation, face, boundary morph and render), ``bench`` (the root
bench's semantic workload: the same without render) and ``faces`` (the
faces the others leave off: plain and hard-seg point-plane ICP with the
residual clip and the Huber weights, and ARAP).

At the identity deformation the frame-1 surfels, frame-0 pixels, project
onto pixel centres of the target within an f32 rounding, so the sampled
target's gradient depends on which side of a pixel line each lands: the
JAX package's and the port's warps differ by an ULP on a few percent of
the coordinates, and those flip cells.  There the losses and their
gradients are held on the JAX package's warped points, and the warp's
backward pass on its own; at a seeded perturbed deformation, where no
surfel sits on a pixel line, end to end.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_helpers import close, port_config, port_frame, port_intr, \
    port_state, semantic_config, semantic_scene, to_np

from super_tpu.core import optimizer as jopt
from super_tpu.core import semantic as jsem
from super_tpu.core.tracker import init_tracker
from super_tpu.render.splat import render_soft as j_render
from super_tpu_torch import convert
from super_tpu_torch.config import semantic_workload_config, workload_config
from super_tpu_torch.core import optimizer as topt
from super_tpu_torch.core import semantic as tsem
from super_tpu_torch.kernels.segsum import segment_gather, segment_plan, \
    segment_reduce
from super_tpu_torch.render.splat import render_soft as t_render


def _faces_config():
    from super_tpu.config import LossConfig

    cfg = semantic_config()
    return cfg.replace(losses=LossConfig(
        sf_point_plane=True, sf_hard_seg_point_plane=True, mesh_arap=True,
        mesh_rot=True, mesh_face=True, sf_point_plane_max=2e-4,
        huber_th=0.5))


CONFIGS = ("semantic", "bench", "faces")


@pytest.fixture(scope="module")
def ctxs():
    """{name: (cfg, intr, frames, jax state, jax ctx, port pieces)}."""
    out = {}
    scenes = {}
    for name in CONFIGS:
        cfg = {"semantic": semantic_config(),
               "bench": semantic_config(render=False),
               "faces": _faces_config()}[name]
        if cfg.data not in scenes:
            intr, _, frames = semantic_scene(3, cfg)
            st = jax.jit(lambda f, c=cfg: init_tracker(c, f))(frames[0])
            scenes[cfg.data] = (intr, frames, st)
        intr, frames, st = scenes[cfg.data]
        ctx = jopt.prepare_autograd(cfg, st.surfels, st.graph, frames[1])
        pcfg, ps = port_config(cfg), port_state(st)
        pctx = topt.prepare_autograd(pcfg, ps.surfels, ps.graph,
                                     port_frame(frames[1]))
        out[name] = types.SimpleNamespace(
            cfg=cfg, intr=intr, frames=frames, st=st, ctx=ctx, pcfg=pcfg,
            ps=ps, pctx=pctx, pintr=port_intr(intr))
    return out


def _deform(j, seed=None, scale=1e-3):
    d = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (j + 1, 1))
    if seed is not None:
        rng = np.random.default_rng(seed)
        d = d + scale * rng.normal(size=d.shape)
    return d.astype(np.float32)


def _grad_close(want, got, rel, name):
    scale = float(np.max(np.abs(np.asarray(want))))
    close(want, got, atol=rel * scale, name=name)


@pytest.mark.parametrize("name", CONFIGS)
def test_prepare_autograd(ctxs, name):
    c = ctxs[name]
    j, t = c.ctx, c.pctx
    # Permuted copies and image transforms of the same f32 inputs: exact.
    for field in ("sf_seg", "sf_seg_conf", "sf_colors", "trg_seg_conf",
                  "num_active_nodes"):
        close(getattr(j, field), getattr(t, field), atol=0, name=field)
    close(j.base.sf_mask, t.base.sf_mask, atol=0, name="sf_mask")
    close(j.base.sf_points, t.base.sf_points, atol=0, name="sf_points")
    if c.cfg.losses.sf_soft_seg_point_plane or \
            c.cfg.losses.sf_hard_seg_point_plane:
        close(j.trg_bank_zx, t.trg_bank_zx, atol=0, name="bank_zx")
    else:
        assert j.trg_bank_zx is None and t.trg_bank_zx is None
    if c.cfg.losses.sf_bn_morph or c.cfg.losses.render_loss:
        for field in ("seg_conf_image", "edge_dt", "color_image",
                      "morph_bank"):
            close(getattr(j.extras, field), getattr(t.extras, field), atol=0,
                  name=field)
        assert float(np.max(np.asarray(j.extras.edge_dt))) > 1.0
    else:
        assert j.extras is None and t.extras is None


def _value_and_grad(c, d):
    """autograd_total at ``d`` on both sides: ((total, parts, grad) JAX,
    (total, parts, grad) port)."""
    (lj, pj), gj = jax.jit(jax.value_and_grad(
        lambda dd: jopt.autograd_total(c.cfg, c.ctx, c.st.graph, dd,
                                       c.intr), has_aux=True))(jnp.asarray(d))
    dt = torch.tensor(d, requires_grad=True)
    lt, pt = topt.autograd_total(c.pcfg, c.pctx, c.ps.graph, dt, c.pintr)
    lt.backward()
    return (lj, pj, gj), (lt.detach(), {k: v.detach() for k, v in pt.items()},
                          dt.grad)


@pytest.mark.parametrize("name", CONFIGS)
def test_autograd_total_perturbed(ctxs, name):
    """Every face and the gradient at a seeded deformation (1e-3 off the
    identity): values at 1e-5 of the total (sums over the surfels of f32
    terms), the gradient at 1e-4 of its largest entry (the T_g row sums
    every surfel's term, with cancellation)."""
    c = ctxs[name]
    (lj, pj, gj), (lt, pt, gt) = _value_and_grad(
        c, _deform(c.st.graph.capacity, seed=0))
    assert set(pj) == set(pt)
    want = {"semantic": {"point_plane", "rot", "face", "bn_morph", "render"},
            "bench": {"point_plane", "rot", "face", "bn_morph"},
            "faces": {"point_plane", "arap", "rot", "face"}}[name]
    assert set(pj) == want
    tol = 1e-5 * float(lj)
    for k in pj:
        close(pj[k], pt[k], atol=tol, name=k)
    close(lj, lt, atol=tol, name="total")
    assert float(lj) > 0 and float(pj["point_plane"]) > 0
    _grad_close(gj, gt, 1e-4, "grad")


def _surfel_faces(cfg, ctx, warped, intr, render, jax_side):
    """The faces that read the warped surfels, on given warped points."""
    losses = cfg.losses
    if jax_side:
        total = losses.sf_point_plane_weight * jopt.point_plane_autograd(
            cfg, ctx, None, intr, warped=warped)
        if losses.sf_bn_morph:
            total += losses.sf_bn_morph_weight * jsem.bn_morph_loss(
                cfg, ctx.extras, warped, ctx.sf_seg, ctx.base.sf_mask, intr)
        if render:
            total += losses.render_loss_weight * jsem.render_loss(
                cfg, ctx.extras, j_render(warped, ctx.sf_colors,
                                          ctx.base.sf_mask, intr, cfg.height,
                                          cfg.width))
        return total
    total = losses.sf_point_plane_weight * topt.point_plane_autograd(
        cfg, ctx, None, intr, warped=warped)
    if losses.sf_bn_morph:
        total = total + losses.sf_bn_morph_weight * tsem.bn_morph_loss(
            cfg, ctx.extras, warped, ctx.sf_seg, ctx.base.sf_mask, intr)
    if render:
        total = total + losses.render_loss_weight * tsem.render_loss(
            cfg, ctx.extras, t_render(warped, ctx.sf_colors,
                                      ctx.base.sf_mask, intr, cfg.height,
                                      cfg.width))
    return total


@pytest.mark.parametrize("name", CONFIGS)
def test_autograd_identity(ctxs, name):
    """At the identity: the warp and its backward pass (a shared cotangent),
    the surfel faces and their gradient in the warped points on the JAX
    package's warped points, and the graph faces end to end."""
    c = ctxs[name]
    d = _deform(c.st.graph.capacity)
    warped_j, vjp = jax.vjp(lambda dd: jopt._warp_all(c.cfg, c.ctx.base, dd),
                            jnp.asarray(d))
    dt = torch.tensor(d, requires_grad=True)
    warped_t = topt._warp_all(c.pcfg, c.pctx, dt)
    cot = np.random.default_rng(1).normal(size=warped_j.shape).astype(
        np.float32)
    torch.sum(warped_t * torch.as_tensor(cot)).backward()
    # Four-anchor blends of ~0.5 m points: an ULP or two (2.4e-7).
    close(warped_j, warped_t, atol=2.4e-7, name="warped")
    flips = np.mean(np.asarray(warped_j) != warped_t.detach().numpy())
    assert flips < 0.1, flips
    _grad_close(vjp(jnp.asarray(cot))[0], dt.grad, 1e-5, "warp vjp")
    # The fit's warp is the LM path's blend, bit for bit.
    from super_tpu_torch.core import losses as tlosses
    geom = tlosses._geom(c.pctx.base)
    beta_kfm = torch.randn((4, 7, geom[1].shape[1]),
                           generator=torch.Generator().manual_seed(2))
    assert torch.equal(topt._warp_fm(geom[1], geom[2], geom[3], beta_kfm),
                       tlosses._warp_fm_batched(geom[1], geom[2], geom[3],
                                                beta_kfm))

    render = c.cfg.losses.render_loss
    # The value op by op (XLA's fusions under jit reassociate the render's
    # window sums: 2e-5 apart from the eager value), the gradient jitted.
    faces_j = lambda w: _surfel_faces(c.cfg, c.ctx, w, c.intr,  # noqa: E731
                                      render, True)
    lj = faces_j(warped_j)
    gj = jax.jit(jax.grad(faces_j))(warped_j)
    wt = torch.tensor(np.asarray(warped_j), requires_grad=True)
    lt = _surfel_faces(c.pcfg, c.pctx, wt, c.pintr, render, False)
    lt.backward()
    close(lj, lt.detach(), atol=1e-5 * float(lj), name="surfel faces")
    _grad_close(gj, wt.grad, 1e-4, "d/dwarped")

    (_, pj, _), (_, pt, _) = _value_and_grad(c, d)
    for k in ("arap", "rot", "face"):
        if k in pj:
            # Zero at the identity up to the rest areas' f32 rounding.
            close(pj[k], pt[k], atol=1e-12, name=k)


def test_bn_morph_misclassified(ctxs):
    """The boundary-morph face where it pulls: on the tiny scene no surfel
    is misclassified far from its boundary (the face is 0 above), so every
    surfel's class is flipped; on the JAX package's warped points at a
    perturbed deformation (the gates then agree exactly), the value at
    1e-5 and the gradient in the warped points at 1e-4 of its largest
    entry."""
    c = ctxs["bench"]
    d = _deform(c.st.graph.capacity, seed=0)
    warped = jopt._warp_all(c.cfg, c.ctx.base, jnp.asarray(d))
    seg_j = 1 - c.ctx.sf_seg
    lj, gj = jax.value_and_grad(lambda w: jsem.bn_morph_loss(
        c.cfg, c.ctx.extras, w, seg_j, c.ctx.base.sf_mask, c.intr))(warped)
    wt = torch.tensor(np.asarray(warped), requires_grad=True)
    lt = tsem.bn_morph_loss(c.pcfg, c.pctx.extras, wt, 1 - c.pctx.sf_seg,
                            c.pctx.base.sf_mask, c.pintr)
    lt.backward()
    assert float(lj) > 15.0, float(lj)       # the mean of pulls > 15 px^2
    close(lj, lt.detach(), atol=1e-5 * float(lj), name="bn_morph")
    _grad_close(gj, wt.grad, 1e-4, "d/dwarped")


def test_optimizer_steps():
    """The fit's Adam and SGD(momentum 0.9) updates (core/optimizer.py:
    fit_update) against optax.adam and optax.sgd(momentum=0.9), two steps
    on seeded gradients: the same update up to an f32 rounding of the
    parameters (two ULPs at 1.0)."""
    rng = np.random.default_rng(2)
    p0 = _deform(40, seed=3, scale=0.1)
    grads = [rng.normal(size=p0.shape).astype(np.float32) * s
             for s in (1.0, 1e-3)]
    for g in grads:
        g[5] = 0.0                          # an inactive node's row
    for name, opt, lr in (("Adam", optax.adam(2e-4), 2e-4),
                          ("SGD", optax.sgd(5e-5, momentum=0.9), 5e-5)):
        pj, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
        pt = torch.tensor(p0)
        tstate = topt.fit_init(pt)
        for g in grads:
            upd, state = opt.update(jnp.asarray(g), state, pj)
            pj = optax.apply_updates(pj, upd)
            pt, tstate = topt.fit_update(name, lr, torch.tensor(g), tstate,
                                         pt)
            close(pj, pt, atol=2.4e-7, name=name)
        close(pj[5], p0[5], atol=0, name=f"{name} zero-gradient row")
        if name == "Adam":
            assert int(tstate.count) == int(state[0].count) == len(grads)


def _jax_fit(c, jit):
    """The JAX package's graph_fit, jitted or op by op (jax.disable_jit:
    its context too, whose f32 roundings differ from the jitted one's)."""
    fit = lambda s, f: jopt.graph_fit(  # noqa: E731
        c.cfg, s.surfels, s.graph, f, c.intr)
    if jit:
        return jax.jit(fit)(c.st, c.frames[1])
    with jax.disable_jit():
        return fit(c.st, c.frames[1])


def test_graph_fit(ctxs):
    """Ten steps of Adam from the identity on the bench's configuration
    (with the render loss the JAX package's eager fit takes minutes here;
    the render face is held above and in the pipeline test).  Step 1
    moves each component by about lr sign(g), and at the identity the
    sampled gradient depends on f32 roundings (module docstring), so the
    fit is held to the JAX package's own spread, its jit fit against its
    eager one, measured here: the port must end within 1.5 times that
    spread of the jit fit (1e-6 if the two agree), its loss likewise."""
    c = ctxs["bench"]
    d_jit, l_jit = _jax_fit(c, True)
    d_eager, l_eager = _jax_fit(c, False)
    d_t, l_t = topt.graph_fit(c.pcfg, c.ps.surfels, c.ps.graph,
                              port_frame(c.frames[1]), c.pintr)
    spread = float(np.max(np.abs(np.asarray(d_jit) - np.asarray(d_eager))))
    err = float(np.max(np.abs(np.asarray(d_jit) - d_t.numpy())))
    print(f"graph_fit: jit-eager spread {spread:.3g}, port-jit {err:.3g}, "
          f"port-eager "
          f"{float(np.max(np.abs(np.asarray(d_eager) - d_t.numpy()))):.3g}; "
          f"losses jit {float(l_jit):.6g} eager {float(l_eager):.6g} "
          f"port {float(l_t):.6g}")
    lr = c.cfg.solver.learning_rate
    assert spread < 10 * lr * c.cfg.solver.num_iterations, spread
    assert err <= max(1.5 * spread, 1e-6), (err, spread)
    lspread = abs(float(l_jit) - float(l_eager))
    assert abs(float(l_t) - float(l_jit)) <= max(1.5 * lspread,
                                                 1e-5 * float(l_jit)), (
        float(l_t), float(l_jit), float(l_eager))
    # Inactive nodes get no gradient and stay at the identity.
    inactive = ~np.asarray(c.st.graph.active)
    close(np.asarray(d_jit)[:-1][inactive], d_t.numpy()[:-1][inactive],
          atol=0, name="inactive rows")


def test_segment_gather_and_reduce_gradcheck():
    """The plain versions (CPU tensors) of the fixed-order gather and sum
    as differentiable ops, in f64: gradcheck, and their backward passes
    against index_select's and index_add's."""
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 7, (40,), generator=gen)
    ids[:3] = 6
    plan = segment_plan(ids, 9)            # segments 7 and 8 stay empty
    x = torch.randn((9, 3), dtype=torch.float64, generator=gen,
                    requires_grad=True)
    vals = torch.randn((40, 3), dtype=torch.float64, generator=gen,
                       requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: segment_gather(a, plan), (x,))
    assert torch.autograd.gradcheck(lambda a: segment_reduce(a, plan),
                                    (vals,))
    cot = torch.randn((40, 3), dtype=torch.float64, generator=gen)
    (g1,) = torch.autograd.grad(segment_gather(x, plan), x, cot)
    (g2,) = torch.autograd.grad(x.index_select(0, plan.ids), x, cot)
    close(g2.numpy(), g1, atol=1e-12, name="gather backward")
    assert torch.equal(segment_reduce(vals, plan),
                       torch.zeros(9, 3, dtype=torch.float64).index_add(
                           0, ids, vals))


def _bench_semantic_config(monkeypatch):
    """The configuration bench.py:build_workload(..., semantic=True)
    derives at 480 x 640, in the port's types (frames and state stubbed
    out)."""
    import bench
    import super_tpu.core.preprocess as jpre
    import super_tpu.core.tracker as jtrk
    import super_tpu.data.synthetic as jsyn

    def fake(n, h, w, **k):
        return types.SimpleNamespace(
            depths=np.zeros((n, h, w), np.float32),
            colors=np.zeros((n, h, w, 3), np.float32),
            segs=np.zeros((n, h, w), np.int32),
            seg_confs=np.zeros((n, k["num_classes"], h, w), np.float32))

    monkeypatch.setattr(jsyn, "generate", fake)
    monkeypatch.setattr(jpre, "preprocess_frame", lambda *a, **k: None)
    monkeypatch.setattr(jtrk, "init_tracker", lambda *a, **k: None)
    args = types.SimpleNamespace(height=480, width=640)
    cfg, _, _, _ = bench.build_workload(args, 30, "per_iteration",
                                        semantic=True)
    return port_config(cfg)


def test_semantic_workload_config_matches_bench(monkeypatch):
    """semantic_workload_config(480, 640) is, field by field, the
    configuration of the root bench's semantic_hz, and the "semantic"
    workload of chip_smoke.py and profile_step.py."""
    got = semantic_workload_config(480, 640)
    want = _bench_semantic_config(monkeypatch)
    for part in ("losses", "solver", "capacity"):
        assert dataclasses.asdict(getattr(got, part)) == \
            dataclasses.asdict(getattr(want, part)), part
    assert got == want == workload_config("semantic")
    assert (got.capacity.surfel_capacity, got.capacity.node_capacity,
            got.capacity.edge_capacity, got.capacity.triangle_capacity) == \
        (393216, 384, 1536, 768)


def test_semantic_super_config():
    """semantic_super_config() and its overrides, field by field."""
    from super_tpu.config import semantic_super_config as j_ssc
    from super_tpu_torch.config import semantic_super_config as t_ssc

    assert t_ssc() == port_config(j_ssc())
    assert t_ssc(num_classes=2, height=48) == port_config(
        j_ssc(num_classes=2, height=48))


def test_semantic_state_crosses(ctxs):
    """A semantic tracker state (class confidences on surfels and nodes)
    crosses into the port and back unchanged."""
    st = ctxs["semantic"].st
    back = convert.to_numpy(convert.tracker_state_from_numpy(
        to_np(st), device="cpu"))
    for part in ("surfels", "graph", "track"):
        want, got = getattr(st, part), getattr(back, part)
        for field in want._fields:
            close(getattr(want, field), getattr(got, field), atol=0,
                  name=f"{part}.{field}")
    assert np.asarray(st.surfels.seg_conf).shape[0] == 2
    assert float(np.max(np.asarray(st.graph.seg_conf))) > 0.5
