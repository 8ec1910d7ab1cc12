"""Deferred (per-pixel) shading over a G-buffer, in plain JAX.

Mirrors the per-pixel shading stage of the reference's deferred sample
(``samples/deferred.py``, reconstructed — SURVEY.md section 3.3): normals
re-normalised per pixel, optional bilinear texture lookup via interpolated
UVs, Lambertian + Phong terms, all masked by coverage. Being plain JAX, it
is differentiable w.r.t. every input (G-buffer, texture, lights, camera),
so gradients flow back through the rasterizer to geometry and pose.

Layout note: all per-pixel vector math runs channels-FIRST internally
([3, H, W]), so channel reductions combine whole image planes instead of
reducing over a 3-wide minor dimension.
"""

from __future__ import annotations

import jax.numpy as jnp

from dirt_tpu.core.texture import sample_texture


def _cf(img):  # [H, W, C] -> [C, H, W]
    return jnp.transpose(jnp.asarray(img), (2, 0, 1))


def shade_deferred(
    gbuffer,
    light_direction,
    light_color,
    ambient=0.0,
    texture=None,
    albedo=None,
    camera_position=None,
    specular_color=None,
    shininess: float = 16.0,
    background=None,
):
    """Shade a G-buffer with a directional light (+ optional specular).

    Args:
        gbuffer: dict with "normal" [H, W, 3], "mask" [H, W, 1]; "uv"
            [H, W, 2] required when ``texture`` is given; "position"
            [H, W, 3] (world space) required for specular.
        light_direction: [3] unit vector toward the light.
        light_color: [C].
        ambient: scalar or [C] ambient term.
        texture: optional [Ht, Wt, C] texture sampled at the G-buffer UVs.
        albedo: optional [H, W, C] base color (defaults to 1s; multiplied
            with the texture if both given).
        camera_position: [3], enables the Phong specular term.
        specular_color: [C] specular albedo (defaults to light_color).
        background: optional [H, W, C] composited where mask == 0.
    Returns:
        [H, W, C] shaded image.
    """
    normal = _cf(gbuffer["normal"])                       # [3, H, W]
    mask = _cf(gbuffer["mask"])                           # [1, H, W]
    n = normal / jnp.sqrt(
        jnp.sum(normal * normal, axis=0, keepdims=True) + 1e-12
    )

    ldir = jnp.asarray(light_direction, jnp.float32)[:, None, None]
    lcol = jnp.asarray(light_color, jnp.float32)
    lcol_cf = lcol.reshape(-1, 1, 1)

    base = mask * 0.0 + 1.0 if albedo is None else _cf(albedo)
    if texture is not None:
        tex = sample_texture(
            jnp.asarray(texture), gbuffer["uv"], channels_first=True
        )
        base = base * tex

    lambert = jnp.maximum(jnp.sum(n * ldir, axis=0, keepdims=True), 0.0)
    ambient_cf = jnp.asarray(ambient, jnp.float32)
    if ambient_cf.ndim == 1:
        ambient_cf = ambient_cf.reshape(-1, 1, 1)
    color = base * (lambert * lcol_cf + ambient_cf)

    if camera_position is not None:
        position = _cf(gbuffer["position"])
        cam = jnp.asarray(camera_position, jnp.float32)[:, None, None]
        view = cam - position
        view = view / jnp.sqrt(
            jnp.sum(view * view, axis=0, keepdims=True) + 1e-12
        )
        cos_nl = jnp.sum(n * ldir, axis=0, keepdims=True)
        reflected = 2.0 * cos_nl * n - ldir
        cos_rv = jnp.maximum(
            jnp.sum(reflected * view, axis=0, keepdims=True), 0.0
        )
        spec_col = lcol_cf if specular_color is None else jnp.asarray(
            specular_color, jnp.float32
        ).reshape(-1, 1, 1)
        lit = (cos_nl > 0.0).astype(color.dtype)
        color = color + spec_col * lit * jnp.power(cos_rv, shininess)

    color = color * mask
    if background is not None:
        color = color + _cf(background) * (1.0 - mask)
    return jnp.transpose(color, (1, 2, 0))
