"""Config #3: textured mesh — UV G-buffer + bilinear texture sampling with
texture gradients, 512^2.

Renders a checker-textured sphere, then recovers a texture from the target
image by gradient descent (gradients flow through the bilinear sampler into
the texture, as in the reference's textured sample — SURVEY.md section 2.2).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from dirt_tpu.core import matrices, mesh
from dirt_tpu.render.gbuffer import render_gbuffer
from dirt_tpu.core.texture import sample_texture
from dirt_tpu.utils.image import save_ppm

OUT = os.path.join(os.path.dirname(__file__), "out")
SIZE = int(os.environ.get("DIRT_DEMO_SIZE", "512"))
STEPS = int(os.environ.get("DIRT_DEMO_STEPS", "60"))


def main():
    os.makedirs(OUT, exist_ok=True)
    verts_obj, faces, uvs = mesh.uv_sphere(n_lat=24, n_lon=48)
    texture = jnp.asarray(mesh.checkerboard_texture(64, 8, 3))

    model_view = matrices.compose(
        matrices.rodrigues(jnp.array([0.3, 0.5, 0.1])),
        matrices.translation(jnp.array([0.0, 0.0, -3.0])),
    )
    projection = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    clip = matrices.transform_homogeneous(
        jnp.asarray(verts_obj), matrices.compose(model_view, projection)
    )

    @jax.jit
    def render(tex):
        gb = render_gbuffer(
            clip, jnp.asarray(faces), {"uv": jnp.asarray(uvs)}, SIZE, SIZE
        )
        color = sample_texture(tex, gb["uv"]) * gb["mask"]
        return color

    target = render(texture)
    save_ppm(os.path.join(OUT, "demo3_textured.ppm"), np.asarray(target))

    # Inverse problem: recover the texture from the rendered image.
    @jax.jit
    def loss_fn(tex):
        return jnp.mean((render(tex) - target) ** 2)

    grad_fn = jax.jit(jax.grad(loss_fn))
    tex = jnp.full_like(texture, 0.5)
    l0 = float(loss_fn(tex))
    lr = 300.0
    # One device-side lax.scan instead of a host-driven dependent loop.
    tex = jax.jit(lambda t0: jax.lax.scan(
        lambda t, _: (t - lr * grad_fn(t), ()), t0, None, length=STEPS
    )[0])(tex)
    l1 = float(loss_fn(tex))
    print(f"texture recovery: loss {l0:.5f} -> {l1:.5f}")
    save_ppm(os.path.join(OUT, "demo3_recovered_texture.ppm"), np.asarray(tex))
    assert l1 < 0.3 * l0
    print("saved", os.path.join(OUT, "demo3_textured.ppm"))


if __name__ == "__main__":
    main()
