#!/usr/bin/env python3
"""Smoke test of dirt_tpu on an NVIDIA GPU: the quickest proof it still runs.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded paths only

One card, in one process:

1. device   — ``jax.devices()``, the JAX version, and the card's name and
              power limit from ``nvidia-smi``.
2. kernels  — the scan kernel compiled for the card (no interpret mode) at
              real widths, ``memory_analysis()`` printed, and compared with
              its plain-XLA twin on three scenes, one per engine; both are
              timed in turns, as information.
3. oracle   — the plain forward, the kernel forward and ``backward_jax``
              against ``ref/slowref.py`` on the 10k-face sphere.
4. main     — the public entry points at real size: fwd+bwd with honest
              caps (overflow flag asserted clear) and finite gradients on
              every engine, the five capability configs through the demo
              pipelines, five Adam steps of config 5 with a falling loss,
              and ``rasterise_batch``.

``--four`` runs only the multi-card paths, each checked against the
one-card result: ``rasterise_sharded`` over 4 row slabs, a (data=2 x
tiles=2) shard_map train step, and ``rasterise_face_sharded`` over 4
face shards.

Any failed check exits non-zero and prints no result line. The last line
of standard output is one JSON object naming the device:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Tolerances of the kernel-vs-plain and oracle comparisons, with why.
# FMA contraction differs between Triton, XLA and the CPU, so a pixel
# centre within f32 rounding of a triangle edge can land on either side.
FID_DIFF_LIMIT = 0.002          # share of pixels whose face id may differ
PIX_TOL = 1e-5                  # atol = rtol where the face ids agree
# The oracle works in float64; the production path in f32 with a
# different (anchored) plane form, so colours agree to f32 interpolation
# error rather than 1e-5.
ORACLE_PIX_TOL = 1e-4
# Gradient sums are segment_sums (atomic adds on the card, in an order
# that changes from run to run) over f32 terms, against float64 loops.
GRAD_REL_TOL = 1e-3
ORACLE_SIZE = 256               # the NumPy oracle takes ~20 s here


def die(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        die(msg)


def log(msg=""):
    print(msg, flush=True)


def _median_ms(fn, args, reps=7):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _in_turns(fa, fb, args, rounds=5):
    """Median ms of two callables timed in turns (a, b, b, a, ...)."""
    import jax

    jax.block_until_ready(fa(*args))
    jax.block_until_ready(fb(*args))
    ta, tb = [], []
    for r in range(rounds):
        order = (fa, fb) if r % 2 == 0 else (fb, fa)
        for f in order:
            t0 = time.perf_counter()
            jax.block_until_ready(f(*args))
            (ta if f is fa else tb).append(time.perf_counter() - t0)
    return statistics.median(ta) * 1e3, statistics.median(tb) * 1e3


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

def _posed_clip(verts_obj, pose=(0.4, 0.3, 0.0), tz=-3.0):
    import jax
    import jax.numpy as jnp
    from dirt_tpu.core import matrices

    @jax.jit
    def to_clip(v):
        mv = matrices.compose(
            matrices.rodrigues(jnp.asarray(pose, jnp.float32)),
            matrices.translation(jnp.array([0.0, 0.0, tz])),
        )
        proj = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
        return matrices.transform_homogeneous(v, matrices.compose(mv, proj))

    return to_clip(jnp.asarray(verts_obj))


def _scene(kind, seed=0):
    """(clip verts [V, 4], colors [V, 3], faces [F, 3]) of a bench scene."""
    import jax.numpy as jnp
    import numpy as np
    from dirt_tpu.core import mesh

    if kind == "cube":
        verts_obj, faces = mesh.cube()
    else:
        n = {"sphere10k": 72, "sphere100k": 224}[kind]
        verts_obj, faces, _ = mesh.uv_sphere(n_lat=n, n_lon=n)
    colors = np.random.RandomState(seed).rand(len(verts_obj), 3)
    return (_posed_clip(verts_obj), jnp.asarray(colors, jnp.float32),
            jnp.asarray(faces))


def _honest(clip_verts, faces, size, clip, base=None):
    """suggest_raster_config caps, with the overflow flag asserted clear."""
    import jax.numpy as jnp
    import dirt_tpu

    config = dirt_tpu.suggest_raster_config(
        clip_verts, faces, size, size, config=base, clip=clip
    )
    _, _, _, overflow = dirt_tpu.rasterise_with_aux(
        jnp.zeros((size, size, 1), jnp.float32), clip_verts,
        jnp.zeros((clip_verts.shape[0], 1), jnp.float32), faces,
        config=config, clip=clip,
    )
    check(not bool(overflow), f"overflow flag set at honest caps ({size}^2)")
    return config


def _screen_faces(clip_verts, colors, faces, size, config, clip):
    import jax
    from dirt_tpu.rasterise_ops import _clip_space_faces

    def faces_of(v, c):
        fv, fa, _, _, overflow = _clip_space_faces(
            v, c, faces, size, size, config, clip)
        return fv, fa, overflow

    fv, fa, clip_ovf = jax.jit(faces_of)(clip_verts, colors)
    check(not bool(clip_ovf), "near-plane clip slots overflowed")
    return fv, fa


def _edge_mask(fid):
    import numpy as np

    e = np.zeros(fid.shape, bool)
    e[:, 1:] |= fid[:, 1:] != fid[:, :-1]
    e[:, :-1] |= fid[:, 1:] != fid[:, :-1]
    e[1:] |= fid[1:] != fid[:-1]
    e[:-1] |= fid[1:] != fid[:-1]
    return e


def _compare_images(label, pix, fid, ref_pix, ref_fid, pix_tol):
    """Face-id maps within FID_DIFF_LIMIT, only at edges; colours at tol."""
    import numpy as np

    pix, fid = np.asarray(pix), np.asarray(fid)
    ref_pix, ref_fid = np.asarray(ref_pix), np.asarray(ref_fid)
    differ = fid != ref_fid
    share = float(differ.mean())
    off_edge = int((differ & ~(_edge_mask(fid) | _edge_mask(ref_fid))).sum())
    same = ~differ
    err = np.abs(pix - ref_pix)[same]
    bound = pix_tol + pix_tol * np.abs(ref_pix[same])
    worst = float((err / bound).max()) if err.size else 0.0
    log(f"  {label}: fid differs on {share:.5%} of pixels (limit "
        f"{FID_DIFF_LIMIT:.1%}), {off_edge} of them off edges (limit 0); "
        f"max |dpix| where fid agrees {float(err.max()) if err.size else 0:.3e}"
        f" = {worst:.3f} x tolerance (atol = rtol = {pix_tol:g})")
    check(share <= FID_DIFF_LIMIT, f"{label}: fid differs on {share:.4%}")
    check(off_edge == 0, f"{label}: {off_edge} fid differences off edges")
    check(worst <= 1.0, f"{label}: pixels outside tolerance")


def _rel_err(got, want):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _finite(label, tree):
    import jax
    import numpy as np

    leaves = [np.asarray(x) for x in jax.tree.leaves(tree)]
    check(all(np.isfinite(x).all() for x in leaves),
          f"{label}: non-finite gradient")
    check(any(np.abs(x).max() > 0 for x in leaves),
          f"{label}: all-zero gradient")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    import jax

    log("== device")
    log(f"  jax {jax.__version__}; devices {jax.devices()}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        die(f"nvidia-smi failed: {e}")
    check(smi, "nvidia-smi printed nothing")
    log(f"  card: {smi}")
    return smi.splitlines()[0]


KERNEL_SCENES = (
    # (label, scene, size, clip, expected engine)
    ("cube 256^2", "cube", 256, True, "dense"),
    ("10k sphere 1024^2", "sphere10k", 1024, False, "packed"),
    ("100k sphere 1024^2 clip on", "sphere100k", 1024, True, "csr"),
)


def phase_kernels():
    import jax
    from dirt_tpu.ops import raster
    from dirt_tpu.ops.raster_fwd import raster_forward, raster_forward_xla

    log("== kernels (Triton scan kernel vs its plain-XLA twin)")
    for label, kind, size, clip, engine in KERNEL_SCENES:
        clip_verts, colors, faces = _scene(kind)
        config = _honest(clip_verts, faces, size, clip)
        fv, fa = _screen_faces(clip_verts, colors, faces, size, config, clip)
        got_engine = raster.resolve_engine(config.concrete(size), fv.shape[0])
        check(got_engine == engine,
              f"{label}: engine {got_engine}, expected {engine}")
        bg = jax.numpy.full((size, size, 3), 0.25, jax.numpy.float32)
        lists, table, bg_chw, overflow = jax.jit(
            lambda a, b, c: raster._scan_inputs(a, b, c, config)
        )(fv, fa, bg)
        check(not bool(jax.numpy.any(overflow)), f"{label}: bins overflow")
        args = (lists, table, bg_chw)
        kern = jax.jit(raster_forward).lower(*args).compile()
        plain = jax.jit(raster_forward_xla).lower(*args).compile()
        log(f"  {label} [{engine}, {fv.shape[0]} faces, lists "
            f"{tuple(lists.base.shape)} x {lists.groups} groups]")
        log(f"    kernel memory_analysis: {kern.memory_analysis()}")
        pix_k, fid_k, _ = kern(*args)
        pix_x, fid_x, _ = plain(*args)
        _compare_images("kernel vs plain", pix_k.transpose(1, 2, 0), fid_k,
                        pix_x.transpose(1, 2, 0), fid_x, PIX_TOL)
        t_k, t_x = _in_turns(kern, plain, args)
        full_k = jax.jit(lambda a, b, c: raster._forward_impl(a, b, c, config))
        full_x = jax.jit(lambda a, b, c: raster._forward_impl(
            a, b, c, config, scan=raster_forward_xla))
        f_k, f_x = _in_turns(full_k, full_x, (fv, fa, bg))
        op_k, op_x = _make_op(raster_forward), _make_op(raster_forward_xla)
        gp = jax.random.normal(jax.random.PRNGKey(0), (size, size, 3))

        def step(op):
            return jax.jit(jax.grad(
                lambda a, b, c, g: (op(a, b, c, config) * g).sum(),
                argnums=(0, 1, 2)))
        s_k, s_x = _in_turns(step(op_k), step(op_x), (fv, fa, bg, gp))
        log(f"    scan: kernel {t_k:.3f} ms, plain {t_x:.3f} ms | "
            f"forward (binning + scan): kernel {f_k:.3f} ms, plain "
            f"{f_x:.3f} ms | fwd+bwd: kernel {s_k:.3f} ms, plain "
            f"{s_x:.3f} ms (medians, in turns)")


def _make_op(scan):
    """rasterize_screen with the given scan and the shared backward."""
    import jax
    from dirt_tpu.ops import raster

    @functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
    def op(fv, fa, bg, config):
        return raster._forward_impl(fv, fa, bg, config, scan=scan)[0]

    def fwd(fv, fa, bg, config):
        p, f, z, _ = raster._forward_impl(fv, fa, bg, config, scan=scan)
        return p, (fv, fa, p, f, z)

    def bwd(config, res, g):
        return raster._bwd(config, res, (g,))

    op.defvjp(fwd, bwd)
    return op


def phase_oracle():
    import jax
    import numpy as np
    from dirt_tpu.ops import raster
    from dirt_tpu.ops.raster_bwd import backward_jax
    from dirt_tpu.ops.raster_fwd import BIG_Z, raster_forward_xla
    from dirt_tpu.ops.triangle_setup import setup_planes
    from dirt_tpu.ref import slowref

    size = ORACLE_SIZE
    log(f"== oracle (ref/slowref.py, float64) on the 10k sphere at {size}^2")
    clip_verts, colors, faces = _scene("sphere10k")
    config = _honest(clip_verts, faces, size, clip=False)
    fv, fa = _screen_faces(clip_verts, colors, faces, size, config, False)
    bg = np.full((size, size, 3), 0.25, np.float32)
    t0 = time.perf_counter()
    ref_pix, ref_fid, ref_z = slowref.oracle_forward(fv, fa, bg)
    ref_z = np.where(np.isinf(ref_z), BIG_Z, ref_z).astype(np.float32)
    log(f"  oracle forward took {time.perf_counter() - t0:.1f} s")
    for name, scan in (("kernel", raster.raster_forward),
                       ("plain", raster_forward_xla)):
        pix, fid, _, _ = jax.jit(lambda a, b, c: raster._forward_impl(
            a, b, c, config, scan=scan))(fv, fa, bg)
        _compare_images(f"{name} forward vs oracle", pix, fid, ref_pix,
                        ref_fid, ORACLE_PIX_TOL)

    gp = np.random.RandomState(3).randn(size, size, 3).astype(np.float32)

    @jax.jit
    def plain_bwd(fv, fa, fid, zbuf, pix, gp):
        (geo, att), vjp = jax.vjp(
            lambda a, b: setup_planes(a, b)[:2], fv, fa)
        d_geo, d_att, d_bg = backward_jax(geo, att, fid, zbuf, pix, gp)
        return (*vjp((d_geo, d_att)), d_bg)

    got = plain_bwd(fv, fa, ref_fid, ref_z, ref_pix, gp)
    t0 = time.perf_counter()
    want = slowref.oracle_backward(fv, fa, bg, ref_fid, ref_z, ref_pix, gp)
    log(f"  oracle backward took {time.perf_counter() - t0:.1f} s")
    for name, g, w in zip(("d_face_verts", "d_face_attrs", "d_background"),
                          got, want):
        err = _rel_err(g, w)
        log(f"  backward_jax {name}: relative error {err:.3e} "
            f"(limit {GRAD_REL_TOL:g}); non-finite entries: backward_jax "
            f"{int((~np.isfinite(np.asarray(g))).sum())}, oracle "
            f"{int((~np.isfinite(np.asarray(w))).sum())}")
        check(err <= GRAD_REL_TOL, f"backward {name} off the oracle")


def phase_main(smi):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import dirt_tpu

    log("== main path (public entry points)")
    # fwd+bwd of the sphere scenes on every engine.
    timing = None
    for kind, size, clip, engine in (
        ("sphere10k", 1024, True, "packed"),
        ("sphere10k", 1024, False, "packed"),
        ("sphere100k", 1024, True, "csr"),
        ("sphere100k", 1024, False, "packed"),
    ):
        clip_verts, colors, faces = _scene(kind)
        config = _honest(clip_verts, faces, size, clip)
        bg = jnp.zeros((size, size, 3), jnp.float32)
        w = jnp.asarray(np.random.RandomState(1).rand(size, size, 3),
                        jnp.float32)

        def loss(v, c, b, w, faces=faces, config=config, clip=clip):
            img = dirt_tpu.rasterise(b, v, c, faces, config=config, clip=clip)
            return jnp.sum(img * w)

        step = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
        grads = step(clip_verts, colors, bg, w)
        _finite(f"{kind} clip={clip}", grads)
        _, _, _, overflow = dirt_tpu.rasterise_with_aux(
            bg, clip_verts, colors, faces, config=config, clip=clip)
        check(not bool(overflow), f"{kind} clip={clip}: overflow")
        ms = _median_ms(step, (clip_verts, colors, bg, w))
        log(f"  {kind} {size}^2 clip={clip} [{engine}]: fwd+bwd ok, "
            f"finite grads, median {ms:.3f} ms")
        if kind == "sphere10k" and not clip:
            timing = ms
    log(f"  info: warmed median fwd+bwd 1024^2 10k sphere = "
        f"{timing:.3f} ms on {smi}")

    _configs()
    _batch()


def _configs():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import dirt_tpu
    from dirt_tpu.core import lighting, matrices, mesh
    from dirt_tpu.core.texture import sample_texture
    from dirt_tpu.render.gbuffer import render_gbuffer
    from demos.demo5_deferred import make_render

    proj = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)

    # 1. square 64^2, orthographic.
    v1 = jnp.array([[-0.5, -0.5, 0, 1], [0.5, -0.5, 0, 1], [0.5, 0.5, 0, 1],
                    [-0.5, 0.5, 0, 1]], jnp.float32)
    f1 = jnp.array([[0, 1, 2], [0, 2, 3]], jnp.int32)
    c1 = jnp.ones((4, 1), jnp.float32)
    img = dirt_tpu.rasterise(None, v1, c1, f1, height=64, width=64,
                             channels=1)
    cov = int((np.asarray(img)[..., 0] > 0.5).sum())
    check(abs(cov - 1024) <= 64, f"config 1: {cov} covered pixels")
    g = jax.grad(lambda v: jnp.sum(dirt_tpu.rasterise(
        None, v, c1, f1, height=64, width=64, channels=1) ** 2))(v1)
    _finite("config 1", g)
    log(f"  config 1 square 64^2: {cov} covered pixels, finite grads")

    # 2. cube 256^2, perspective, vertex colours.
    verts_obj, f2 = mesh.cube()
    v2 = _posed_clip(verts_obj, pose=(0.5, 0.8, 0.0))
    c2 = jnp.asarray(verts_obj + 0.5, jnp.float32)
    f2 = jnp.asarray(f2)
    s2 = 256
    bg2 = jnp.full((s2, s2, 3), 0.1, jnp.float32)
    cfg2 = _honest(v2, f2, s2, True)
    g = jax.jit(jax.grad(lambda v, c: jnp.sum(dirt_tpu.rasterise(
        bg2, v, c, f2, config=cfg2) ** 2), argnums=(0, 1)))(v2, c2)
    _finite("config 2", g)
    log(f"  config 2 cube {s2}^2: finite grads")

    # 3. textured 512^2: UV G-buffer + bilinear sampling, texture grads.
    verts_obj, f3, uvs = mesh.uv_sphere(n_lat=24, n_lon=48)
    f3, uvs = jnp.asarray(f3), jnp.asarray(uvs)
    v3 = _posed_clip(verts_obj, pose=(0.3, 0.5, 0.1))
    tex = jnp.asarray(mesh.checkerboard_texture(64, 8, 3))
    s3 = 512
    cfg3 = _honest(v3, f3, s3, True)

    def textured(v, t):
        gb = render_gbuffer(v, f3, {"uv": uvs}, s3, s3, config=cfg3)
        return sample_texture(t, gb["uv"]) * gb["mask"]

    g = jax.jit(jax.grad(lambda v, t: jnp.sum(textured(v, t) ** 2),
                         argnums=(0, 1)))(v3, tex)
    _finite("config 3", g)
    log(f"  config 3 textured {s3}^2: finite grads to vertices and texture")

    # 4. lit 512^2: gradients to the light and the pose.
    verts4 = jnp.asarray(verts_obj)
    albedo = jnp.broadcast_to(jnp.array([0.9, 0.6, 0.3]), verts4.shape)
    cfg4 = _honest(_posed_clip(verts_obj), f3, s3, True)

    def lit(light, pose):
        light = light / jnp.linalg.norm(light)
        model = matrices.compose(
            matrices.rodrigues(pose),
            matrices.translation(jnp.array([0.0, 0.0, -3.0])))
        world = matrices.transform_homogeneous(verts4, model)[..., :3]
        normals = lighting.vertex_normals(world, f3)
        shaded = lighting.diffuse_directional(
            normals, albedo, light, jnp.ones(3)
        ) + lighting.specular_directional(
            world, normals, jnp.full_like(albedo, 0.4),
            camera_position=jnp.zeros(3), light_direction=light,
            light_color=jnp.ones(3), shininess=20.0)
        clip = matrices.transform_homogeneous(world, proj)
        return dirt_tpu.rasterise(jnp.zeros((s3, s3, 3), jnp.float32),
                                  clip, shaded, f3, config=cfg4)

    g = jax.jit(jax.grad(lambda l, p: jnp.sum(lit(l, p) ** 2),
                         argnums=(0, 1)))(jnp.array([0.3, 0.8, 0.52]),
                                          jnp.array([0.4, 0.3, 0.0]))
    _finite("config 4", g)
    check(all(np.abs(np.asarray(x)).max() > 0 for x in g),
          "config 4: zero gradient to the light or the pose")
    log(f"  config 4 lit {s3}^2: finite, nonzero grads to light and pose")

    # 5. deferred 10k at 1024^2 (demos/demo5_deferred.py's pipeline), and
    # five Adam steps of pose + vertex-bump fitting.
    verts_obj, f5, uv5 = mesh.uv_sphere(n_lat=72, n_lon=72)
    verts5, f5, uv5 = (jnp.asarray(verts_obj), jnp.asarray(f5),
                       jnp.asarray(uv5))
    s5 = 1024
    cfg5 = _honest(_posed_clip(verts_obj), f5, s5, True)
    render = jax.jit(make_render(
        f5, uv5, jnp.asarray(mesh.checkerboard_texture(128, 10, 3)), proj,
        cfg5, size=s5))
    target = render(verts5, jnp.array([0.4, 0.3, 0.0]))

    def loss_fn(params):
        verts = verts5 * (1.0 + params["bump"][:, None])
        return jnp.mean((render(verts, params["pose"]) - target) ** 2)

    @jax.jit
    def adam(params, m, v, t):
        loss, g = jax.value_and_grad(loss_fn)(params)
        m = jax.tree.map(lambda a, b: 0.9 * a + 0.1 * b, m, g)
        v = jax.tree.map(lambda a, b: 0.999 * a + 0.001 * b * b, v, g)
        lr = {"pose": 5e-3, "bump": 2e-4}
        params = jax.tree.map(
            lambda p, a, b, r: p - r * (a / (1 - 0.9 ** t))
            / (jnp.sqrt(b / (1 - 0.999 ** t)) + 1e-8),
            params, m, v, lr)
        return params, m, v, loss, g

    params = {"pose": jnp.array([0.52, 0.22, 0.05]),
              "bump": jnp.zeros((verts5.shape[0],))}
    m = jax.tree.map(jnp.zeros_like, params)
    v = jax.tree.map(jnp.zeros_like, params)
    losses = []
    for t in range(1, 6):
        params, m, v, loss, g = adam(params, m, v, float(t))
        _finite(f"config 5 step {t}", g)
        losses.append(float(loss))
    final = float(loss_fn(params))
    log(f"  config 5 deferred 10k {s5}^2: Adam losses "
        f"{', '.join(f'{x:.6f}' for x in losses)} -> {final:.6f}")
    check(final < losses[0], "config 5: the loss did not fall")


def _max_caps(configs):
    """One config whose every cap is the largest of ``configs``'."""
    fields = ("bin_cap", "expand_cap", "budget", "clip_cap", "pool_cap",
              "work_cap")
    merged = configs[0]
    for c in configs[1:]:
        merged = merged._replace(**{
            f: max(getattr(merged, f), getattr(c, f))
            for f in fields if getattr(c, f) is not None
        })
    return merged


def _batch():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import dirt_tpu
    from dirt_tpu.core import mesh

    size = 512
    verts_obj, faces, _ = mesh.uv_sphere(n_lat=72, n_lon=72)
    faces = jnp.asarray(faces)
    views = jnp.stack([_posed_clip(verts_obj, pose=(0.4, 0.3 + 0.5 * i, 0.0))
                       for i in range(4)])
    colors = jnp.asarray(np.random.RandomState(0).rand(4, len(verts_obj), 3),
                         jnp.float32)
    config = _max_caps([
        dirt_tpu.suggest_raster_config(views[i], faces, size, size)
        for i in range(4)
    ])
    for i in range(4):
        _, _, _, overflow = dirt_tpu.rasterise_with_aux(
            jnp.zeros((size, size, 3), jnp.float32), views[i], colors[i],
            faces, config=config)
        check(not bool(overflow), f"rasterise_batch view {i}: overflow")
    imgs = dirt_tpu.rasterise_batch(None, views, colors, faces, size, size,
                                    3, config=config)
    one = dirt_tpu.rasterise(None, views[2], colors[2], faces, size, size, 3,
                             config=config)
    err = float(jnp.abs(imgs[2] - one).max())
    check(err <= 1e-5, f"rasterise_batch view 2 differs from rasterise: {err}")
    g = jax.jit(jax.grad(lambda v, c: jnp.sum(dirt_tpu.rasterise_batch(
        None, v, c, faces, size, size, 3, config=config) ** 2),
        argnums=(0, 1)))(views, colors)
    _finite("rasterise_batch", g)
    log(f"  rasterise_batch 4 views {size}^2: overflow clear, view 2 "
        f"matches rasterise (max diff {err:.2e}), finite grads")


def phase_four():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    import dirt_tpu
    from dirt_tpu.core import mesh
    from dirt_tpu.ops.raster import RasterConfig
    from dirt_tpu.parallel.face_sharding import rasterise_face_sharded
    from dirt_tpu.parallel.sharding import rasterise_sharded, slab_render

    log("== four cards (each checked against one card)")
    devs = jax.devices()[:4]
    size = 1024
    clip_verts, colors, faces = _scene("sphere10k")
    # One tile grid for both sides (64-row tiles): per-tile bins of a slab
    # are then a subset of the whole image's, so the whole image's honest
    # dense cap also holds on every slab and face shard.
    config = _honest(clip_verts, faces, size, False,
                     base=RasterConfig(engine="dense", tile_h=64))
    bg = jnp.full((size, size, 3), 0.25, jnp.float32)
    w = jnp.asarray(np.random.RandomState(1).rand(size, size, 3),
                    jnp.float32)

    def single(v, c):
        return dirt_tpu.rasterise(bg, v, c, faces, config=config, clip=False)

    def compare(label, render):
        def loss(v, c):
            return jnp.sum(render(v, c) * w)

        img = jax.jit(render)(clip_verts, colors)
        ref = jax.jit(single)(clip_verts, colors)
        err = float(jnp.abs(img - ref).max())
        g = jax.jit(jax.grad(loss, argnums=(0, 1)))(clip_verts, colors)
        g1 = jax.jit(jax.grad(lambda v, c: jnp.sum(single(v, c) * w),
                              argnums=(0, 1)))(clip_verts, colors)
        _finite(label, g)
        rel = [_rel_err(a, b) for a, b in zip(g, g1)]
        log(f"  {label}: max |image - one card| {err:.2e}; gradient "
            f"relative error verts {rel[0]:.2e}, colors {rel[1]:.2e} "
            f"(limit {GRAD_REL_TOL:g})")
        check(err <= 1e-4, f"{label}: image differs from one card")
        check(max(rel) <= GRAD_REL_TOL, f"{label}: gradients differ")

    tiles = Mesh(np.array(devs), ("tiles",))
    compare(f"rasterise_sharded tiles=4 {size}^2", lambda v, c: rasterise_sharded(
        bg, v, c, faces, tiles, config=config))
    fmesh = Mesh(np.array(devs), ("faces",))
    compare(f"rasterise_face_sharded faces=4 {size}^2",
            lambda v, c: rasterise_face_sharded(
                bg, v, c, faces, fmesh, config=config))

    # (data=2 x tiles=2) shard_map train step: two poses, each rendered as
    # two row slabs, losses psum'd over both axes (__graft_entry__.py).
    verts_obj, _, _ = mesh.uv_sphere(n_lat=72, n_lon=72)
    poses = jnp.array([[0.4, 0.3, 0.0], [0.1, 0.6, 0.2]], jnp.float32)
    clips = jnp.stack([_posed_clip(verts_obj, pose=tuple(p.tolist()))
                       for p in np.asarray(poses)])
    targets = jnp.asarray(np.random.RandomState(2).rand(2, size, size, 3),
                          jnp.float32)

    def scene_loss(bump, clip_v, target, render):
        return jnp.sum((render(clip_v * (1.0 + bump[:, None])) - target) ** 2)

    def loss_single(bump):
        return sum(scene_loss(bump, clips[i], targets[i], lambda v: single(
            v, colors)) for i in range(2))

    mesh2 = Mesh(np.array(devs).reshape(2, 2), ("data", "tiles"))

    def per_device(bump, clip_blk, target_blk):
        def render_slab(v):
            bg_slab = jax.lax.dynamic_slice_in_dim(
                bg, jax.lax.axis_index("tiles") * (size // 2), size // 2, 0)
            return slab_render(bg_slab, v, colors, faces, size, size,
                               "tiles", config)

        sq = scene_loss(bump, clip_blk[0], target_blk[0], render_slab)
        return jax.lax.psum(sq, ("data", "tiles"))

    def loss_sharded(bump):
        return jax.shard_map(
            per_device, mesh=mesh2,
            in_specs=(P(), P("data"), P("data", "tiles")),
            out_specs=P(), check_vma=False,
        )(bump, clips, targets)

    bump = jnp.zeros((clip_verts.shape[0],), jnp.float32)
    l_s, g_s = jax.jit(jax.value_and_grad(loss_sharded))(bump)
    l_1, g_1 = jax.jit(jax.value_and_grad(loss_single))(bump)
    _finite("train step", g_s)
    rel = _rel_err(g_s, g_1)
    log(f"  data=2 x tiles=2 train step {size}^2: loss {float(l_s):.4f} vs "
        f"one card {float(l_1):.4f}; gradient relative error {rel:.2e} "
        f"(limit {GRAD_REL_TOL:g})")
    check(abs(float(l_s) - float(l_1)) <= 1e-4 * abs(float(l_1)),
          "train step loss differs from one card")
    check(rel <= GRAD_REL_TOL, "train step gradient differs from one card")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card sharded paths")
    args = parser.parse_args()

    if not os.path.isdir(os.path.join(HERE, "dirt_tpu")):
        die("the dirt_tpu package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        die(f"no GPU: JAX found {devices}")
    need = 4 if args.four else 1
    check(len(devices) >= need, f"needs {need} GPUs, found {len(devices)}")

    from dirt_tpu.config import use_interpret
    from dirt_tpu.utils.compilecache import enable_compile_cache

    check(not use_interpret(), "kernels would run in interpret mode")
    log(f"compile cache: {enable_compile_cache()}")
    smi = phase_device()
    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_kernels()
        phase_oracle()
        phase_main(smi)
    log(f"all phases passed in {time.perf_counter() - t0:.0f} s")
    log(smi)
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
