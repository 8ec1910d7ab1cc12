"""Config #4: lit mesh — per-vertex normals, Lambertian + specular shading,
gradients w.r.t. lights and pose, 512^2.

Forward: per-vertex shading (reference ``dirt/lighting.py`` style) baked
into vertex colors, rasterized once. Inverse: recover the light direction
and an object rotation offset from the target image by gradient descent.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import dirt_tpu
from dirt_tpu.core import lighting, matrices, mesh
from dirt_tpu.utils.image import save_ppm

OUT = os.path.join(os.path.dirname(__file__), "out")
SIZE = int(os.environ.get("DIRT_DEMO_SIZE", "512"))
STEPS = int(os.environ.get("DIRT_DEMO_STEPS", "80"))


def main():
    os.makedirs(OUT, exist_ok=True)
    verts_obj, faces, _ = mesh.uv_sphere(n_lat=24, n_lon=48)
    verts_obj = jnp.asarray(verts_obj)
    faces = jnp.asarray(faces)
    albedo = jnp.broadcast_to(
        jnp.array([0.9, 0.6, 0.3], jnp.float32), (verts_obj.shape[0], 3)
    )
    projection = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)

    @jax.jit
    def render(light_dir_raw, pose):
        light_dir = light_dir_raw / jnp.linalg.norm(light_dir_raw)
        model = matrices.compose(
            matrices.rodrigues(pose),
            matrices.translation(jnp.array([0.0, 0.0, -3.0])),
        )
        world = matrices.transform_homogeneous(verts_obj, model)[..., :3]
        normals = lighting.vertex_normals(world, faces)
        shaded = lighting.diffuse_directional(
            normals, albedo, light_dir, jnp.ones(3)
        ) + lighting.specular_directional(
            world, normals, jnp.full_like(albedo, 0.4),
            camera_position=jnp.zeros(3),
            light_direction=light_dir, light_color=jnp.ones(3),
            shininess=20.0,
        )
        clip = matrices.transform_homogeneous(world, projection)
        return dirt_tpu.rasterise(
            jnp.zeros((SIZE, SIZE, 3), jnp.float32), clip, shaded, faces
        )

    true_light = jnp.array([0.3, 0.8, 0.52])
    true_pose = jnp.array([0.4, 0.3, 0.0])
    target = render(true_light, true_pose)
    save_ppm(os.path.join(OUT, "demo4_lit.ppm"), np.asarray(target))

    @jax.jit
    def loss_fn(params):
        return jnp.mean((render(params["light"], params["pose"]) - target) ** 2)

    grad_fn = jax.jit(jax.grad(loss_fn))
    params = {
        "light": jnp.array([0.0, 1.0, 0.3]),
        "pose": jnp.array([0.55, 0.2, 0.05]),
    }
    l0 = float(loss_fn(params))
    lr = {"light": 3.0, "pose": 0.5}

    def step(p, _):
        g = grad_fn(p)
        return {k: p[k] - lr[k] * g[k] for k in p}, ()

    # One device-side lax.scan instead of a host-driven loop.
    params = jax.jit(lambda p: jax.lax.scan(
        step, p, None, length=STEPS)[0])(params)
    l1 = float(loss_fn(params))
    rec_light = params["light"] / jnp.linalg.norm(params["light"])
    print(f"light/pose recovery: loss {l0:.6f} -> {l1:.6f}")
    print("  light", np.asarray(rec_light).round(3),
          "(true", np.asarray(true_light).round(3), ")")
    print("  pose ", np.asarray(params["pose"]).round(3),
          "(true", np.asarray(true_pose).round(3), ")")
    assert l1 < 0.25 * l0
    print("saved", os.path.join(OUT, "demo4_lit.ppm"))


if __name__ == "__main__":
    main()
