"""Config #5: deferred shading — G-buffer (position/normal/UV/mask) raster +
per-pixel shading pass; full inverse-rendering vertex + camera optimization
on a ~10k-triangle mesh at 1024^2.

This is the flagship pipeline (SURVEY.md section 3.3): every capability in
one stack — raster G-buffer, per-pixel texture + Lambert + specular, losses
through the whole graph back to vertex positions and camera pose.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import jax
import jax.numpy as jnp
import numpy as np

from dirt_tpu.core import lighting, matrices, mesh
from dirt_tpu.render.deferred import shade_deferred
from dirt_tpu.render.gbuffer import render_gbuffer
from dirt_tpu.ops.raster import RasterConfig
from dirt_tpu.utils.checkpoint import load_pytree, save_pytree
from dirt_tpu.utils.image import save_ppm
from dirt_tpu.utils.metrics import MetricsLogger

OUT = os.path.join(os.path.dirname(__file__), "out")
SIZE = int(os.environ.get("DIRT_DEMO_SIZE", "1024"))
STEPS = int(os.environ.get("DIRT_DEMO_STEPS", "80"))
# ~10k triangles: 2 * 72 * 72 ~ 10.2k
N_LAT = int(os.environ.get("DIRT_DEMO_LAT", "72"))
N_LON = int(os.environ.get("DIRT_DEMO_LON", "72"))


def build_scene():
    verts_obj, faces, uvs = mesh.uv_sphere(n_lat=N_LAT, n_lon=N_LON)
    print(f"mesh: {len(verts_obj)} verts, {len(faces)} tris, {SIZE}^2 px")
    texture = jnp.asarray(mesh.checkerboard_texture(128, 10, 3))
    projection = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    return jnp.asarray(verts_obj), jnp.asarray(faces), jnp.asarray(uvs), \
        texture, projection


def make_render(faces, uvs, texture, projection, config, size=SIZE):
    light_dir = jnp.array([0.35, 0.75, 0.56])
    light_dir = light_dir / jnp.linalg.norm(light_dir)

    def render(verts_obj, pose):
        model = matrices.compose(
            matrices.rodrigues(pose),
            matrices.translation(jnp.array([0.0, 0.0, -3.0])),
        )
        world = matrices.transform_homogeneous(verts_obj, model)[..., :3]
        normals = lighting.vertex_normals(world, faces)
        clip = matrices.transform_homogeneous(world, projection)
        gb = render_gbuffer(
            clip, faces,
            {"position": world, "normal": normals, "uv": uvs},
            size, size, config=config,
        )
        return shade_deferred(
            gb, light_dir, jnp.ones(3), ambient=0.12, texture=texture,
            camera_position=jnp.zeros(3), shininess=24.0,
        )

    return render


def main():
    os.makedirs(OUT, exist_ok=True)
    verts_obj, faces, uvs, texture, projection = build_scene()
    # Count-then-allocate caps: the auto heuristics flag (and truncate)
    # this 10k-face mesh's silhouette spans at 1024^2 (round-3 audit).
    import dirt_tpu as _dirt
    from dirt_tpu.core import matrices as _mat

    mv0 = _mat.compose(
        _mat.rodrigues(jnp.array([0.4, 0.3, 0.0])),
        _mat.translation(jnp.array([0.0, 0.0, -3.0])),
    )
    clip0 = _mat.transform_homogeneous(
        jnp.asarray(verts_obj), _mat.compose(mv0, projection)
    )
    config = _dirt.suggest_raster_config(clip0, faces, SIZE, SIZE)
    render = jax.jit(make_render(faces, uvs, texture, projection, config))

    true_pose = jnp.array([0.4, 0.3, 0.0])
    t0 = time.time()
    target = render(verts_obj, true_pose)
    jax.block_until_ready(target)
    print(f"first render (compile+run): {time.time() - t0:.1f}s")
    save_ppm(os.path.join(OUT, "demo5_deferred.ppm"), np.asarray(target))

    t0 = time.time()
    target = render(verts_obj, true_pose)
    jax.block_until_ready(target)
    dt = time.time() - t0
    print(f"steady-state forward: {dt*1e3:.1f} ms ({SIZE*SIZE/dt/1e6:.0f} Mpix/s)")

    # Inverse rendering: recover pose offset + vertex displacement field.
    @jax.jit
    def loss_fn(params):
        verts = verts_obj * (1.0 + params["bump"][:, None])
        img = render(verts, params["pose"])
        return jnp.mean((img - target) ** 2)

    grad_fn = jax.jit(jax.grad(loss_fn))
    params = {
        "pose": jnp.array([0.52, 0.22, 0.05]),
        "bump": jnp.zeros((verts_obj.shape[0],)),
    }
    l0 = float(loss_fn(params))
    # Adam, two phases: camera pose first, then joint pose + vertex bumps
    # (joint from the start lets the displacement field absorb pose error).
    # Per-group learning rates: Adam normalises per-parameter step size, so
    # the dense bump field needs a genuinely smaller lr, not a scaled grad.
    m = jax.tree.map(jnp.zeros_like, params)
    v = jax.tree.map(jnp.zeros_like, params)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def step(carry, inputs):
        params, m, v = carry
        t, lrs = inputs
        loss, g = jax.value_and_grad(loss_fn)(params)
        m = jax.tree.map(lambda a, b: b1 * a + (1 - b1) * b, m, g)
        v = jax.tree.map(lambda a, b: b2 * a + (1 - b2) * b * b, v, g)
        mh = jax.tree.map(lambda a: a / (1 - b1 ** t), m)
        vh = jax.tree.map(lambda a: a / (1 - b2 ** t), v)
        new = jax.tree.map(
            lambda p, lr, a, b: p - lr * a / (jnp.sqrt(b) + eps),
            params, lrs, mh, vh,
        )
        return (new, m, v), loss

    # All steps run device-side in one lax.scan instead of a host-driven
    # dependent loop.
    pose_only = STEPS // 2
    ts = jnp.arange(1, STEPS + 1, dtype=jnp.float32)
    lrs_seq = {
        "pose": jnp.full((STEPS,), 5e-3, jnp.float32),
        "bump": jnp.where(ts <= pose_only, 0.0, 2e-4).astype(jnp.float32),
    }
    run = jax.jit(lambda carry: jax.lax.scan(step, carry, (ts, lrs_seq)))
    run.lower((params, m, v)).compile()  # AOT compile, no execution
    t0 = time.time()
    (params, m, v), losses = run((params, m, v))
    jax.block_until_ready(params["pose"])
    l1 = float(loss_fn(params))

    # Loss curve -> CSV; optimizer state -> resumable checkpoint.
    losses = np.asarray(losses)
    logger = MetricsLogger(os.path.join(OUT, "demo5_metrics.csv"),
                           print_every=STEPS)
    for i, lv in enumerate(losses):
        logger.log(i + 1, loss=lv)
    logger.close()
    save_pytree(os.path.join(OUT, "demo5_ckpt.npz"),
                {"params": params, "m": m, "v": v, "step": STEPS})
    restored = load_pytree(os.path.join(OUT, "demo5_ckpt.npz"))
    assert float(jnp.max(jnp.abs(
        restored["params"]["pose"] - params["pose"]))) == 0.0
    print(f"inverse rendering: loss {l0:.6f} -> {l1:.6f} "
          f"({STEPS} Adam steps, {(time.time()-t0)/STEPS*1e3:.0f} ms/step)")
    print("  pose", np.asarray(params["pose"]).round(3),
          "(true", np.asarray(true_pose).round(3), ")")
    final = render(verts_obj * (1.0 + params["bump"][:, None]), params["pose"])
    save_ppm(os.path.join(OUT, "demo5_recovered.ppm"), np.asarray(final))
    assert l1 < 0.5 * l0
    print("saved", os.path.join(OUT, "demo5_deferred.ppm"))


if __name__ == "__main__":
    main()
