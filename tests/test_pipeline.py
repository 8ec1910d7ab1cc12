"""Integration tests: the five driver configs at small sizes (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dirt_tpu
from dirt_tpu.core import lighting, matrices, mesh
from dirt_tpu.core.texture import sample_texture
from dirt_tpu.render.deferred import shade_deferred
from dirt_tpu.render.gbuffer import render_gbuffer


def _cube_clip(angle=(0.5, 0.8, 0.0), dist=3.0):
    verts_obj, faces = mesh.cube()
    mv = matrices.compose(
        matrices.rodrigues(jnp.array(angle)),
        matrices.translation(jnp.array([0.0, 0.0, -dist])),
    )
    proj = matrices.perspective_projection(0.1, 20.0, 0.05, 1.0)
    clip = matrices.transform_homogeneous(
        jnp.asarray(verts_obj), matrices.compose(mv, proj)
    )
    return verts_obj, jnp.asarray(faces), clip


def test_config1_square():
    vertices = jnp.array(
        [[-0.5, -0.5, 0, 1], [0.5, -0.5, 0, 1], [0.5, 0.5, 0, 1],
         [-0.5, 0.5, 0, 1]], jnp.float32,
    )
    faces = jnp.array([[0, 1, 2], [0, 2, 3]], jnp.int32)
    img = dirt_tpu.rasterise(
        None, vertices, jnp.ones((4, 1)), faces, height=64, width=64,
        channels=1,
    )
    coverage = int((np.asarray(img)[..., 0] > 0.5).sum())
    assert abs(coverage - 1024) <= 64  # 32x32 square


def test_config2_cube_zbuffer():
    verts_obj, faces, clip = _cube_clip()
    colors = jnp.asarray(verts_obj + 0.5, jnp.float32)
    img = dirt_tpu.rasterise(jnp.zeros((128, 128, 3)), clip, colors, faces)
    img = np.asarray(img)
    assert 0.05 < (img.sum(-1) > 0.05).mean() < 0.9
    assert np.isfinite(img).all()
    # Z-buffering: closest face wins -> no pixel exceeds max vertex color.
    assert img.max() <= 1.0 + 1e-5


def test_config3_textured_gbuffer():
    verts_obj, faces, clip = _cube_clip()
    uvs = jnp.asarray((np.asarray(verts_obj)[:, :2] + 0.5), jnp.float32)
    tex = jnp.asarray(mesh.checkerboard_texture(16, 4, 3))

    def render(tex):
        gb = render_gbuffer(clip, faces, {"uv": uvs}, 96, 96)
        return sample_texture(tex, gb["uv"]) * gb["mask"]

    img = render(tex)
    assert np.isfinite(np.asarray(img)).all()
    # Texture gradients flow (the reference's headline textured capability).
    g = jax.grad(lambda t: jnp.sum(render(t) ** 2))(tex)
    assert np.abs(np.asarray(g)).max() > 0


@pytest.mark.slow
def test_config4_lit_gradients_to_light_and_pose():
    verts_obj, faces, _ = _cube_clip()
    verts_obj = jnp.asarray(verts_obj)
    proj = matrices.perspective_projection(0.1, 20.0, 0.05, 1.0)

    def render(light_dir, pose):
        model = matrices.compose(
            matrices.rodrigues(pose),
            matrices.translation(jnp.array([0.0, 0.0, -3.0])),
        )
        world = matrices.transform_homogeneous(verts_obj, model)[..., :3]
        normals = lighting.vertex_normals(world, faces)
        shaded = lighting.diffuse_directional(
            normals, jnp.ones((8, 3)) * 0.8, light_dir, jnp.ones(3)
        )
        clip = matrices.transform_homogeneous(world, proj)
        return dirt_tpu.rasterise(jnp.zeros((96, 96, 3)), clip, shaded, faces)

    light = jnp.array([0.3, 0.8, 0.52])
    pose = jnp.array([0.5, 0.8, 0.0])
    img = render(light, pose)
    assert float(jnp.max(img)) > 0.1

    g_light, g_pose = jax.grad(
        lambda l, p: jnp.sum(render(l, p) ** 2), argnums=(0, 1)
    )(light, pose)
    assert np.abs(np.asarray(g_light)).max() > 0
    assert np.abs(np.asarray(g_pose)).max() > 0
    assert np.isfinite(np.asarray(g_pose)).all()


@pytest.mark.slow
def test_config5_deferred_full_graph():
    verts_obj, faces, clip = _cube_clip()
    verts_obj = jnp.asarray(verts_obj)
    uvs = jnp.asarray((np.asarray(verts_obj)[:, :2] + 0.5), jnp.float32)
    tex = jnp.asarray(mesh.checkerboard_texture(16, 4, 3))
    proj = matrices.perspective_projection(0.1, 20.0, 0.05, 1.0)
    light = jnp.array([0.0, 0.707, 0.707])

    def render(verts, pose):
        model = matrices.compose(
            matrices.rodrigues(pose),
            matrices.translation(jnp.array([0.0, 0.0, -3.0])),
        )
        world = matrices.transform_homogeneous(verts, model)[..., :3]
        normals = lighting.vertex_normals(world, faces)
        clip = matrices.transform_homogeneous(world, proj)
        gb = render_gbuffer(
            clip, faces,
            {"position": world, "normal": normals, "uv": uvs}, 96, 96,
        )
        return shade_deferred(
            gb, light, jnp.ones(3), ambient=0.1, texture=tex,
            camera_position=jnp.zeros(3),
        )

    pose = jnp.array([0.5, 0.8, 0.0])
    img = render(verts_obj, pose)
    assert np.isfinite(np.asarray(img)).all()
    assert float(jnp.max(img)) > 0.1

    # Full inverse-rendering graph: gradients w.r.t. vertices AND pose.
    g_v, g_p = jax.grad(
        lambda v, p: jnp.sum(render(v, p) ** 2), argnums=(0, 1)
    )(verts_obj, pose)
    assert np.abs(np.asarray(g_v)).max() > 0
    assert np.abs(np.asarray(g_p)).max() > 0


def test_gbuffer_buffers_are_consistent():
    verts_obj, faces, clip = _cube_clip()
    gb = render_gbuffer(
        clip, faces, {"normal": jnp.ones((8, 3))}, 64, 64
    )
    mask = np.asarray(gb["mask"])[..., 0]
    fid = np.asarray(gb["fid"])
    assert ((mask > 0.5) == (fid >= 0)).all()
    assert set(np.unique(fid)) <= set(range(-1, 12))
