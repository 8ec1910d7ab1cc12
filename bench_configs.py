"""Per-config benchmark: the five BASELINE.json capability configs.

Prints one line per config with honest device timings (fwd and full
gradient step). ``bench.py`` stays the driver's single-metric entry point;
this script is the broader capability/performance sheet.
"""

import sys

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from dirt_tpu.utils.compilecache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from dirt_tpu.core import lighting, matrices, mesh  # noqa: E402
from dirt_tpu.render.deferred import shade_deferred  # noqa: E402
from dirt_tpu.render.gbuffer import render_gbuffer  # noqa: E402
from dirt_tpu.utils.benchtime import device_time  # noqa: E402
import dirt_tpu  # noqa: E402


def _report(name, size, fwd_fn, fwd_args, loss_fn, loss_args):
    # The rep-count differencing needs (r2 - r1) * t well above the host
    # jitter, so small/fast configs need many reps. Rolled fori_loop reps
    # are free at compile time.
    r2 = {64: 601, 256: 301, 512: 101}.get(size, 26)
    t_f = device_time(fwd_fn, fwd_args, r1=2, r2=r2, samples=3)
    t_b = device_time(
        jax.grad(loss_fn, argnums=tuple(range(len(loss_args)))),
        loss_args, r1=2, r2=r2, samples=3,
    )
    mpix = size * size / 1e6
    print(f"{name:46s} fwd {t_f*1e3:7.2f} ms ({mpix/t_f:7.1f} Mpix/s)   "
          f"grad-step {t_b*1e3:7.2f} ms ({mpix/t_b:6.1f} Mpix/s)")


def _weights(size, c, seed=1):
    return jnp.asarray(np.random.RandomState(seed).rand(size, size, c),
                       jnp.float32)


def _honest(clipv, faces, size, clip=True):
    """Count-then-allocate config + hard assert the render is complete.

    The round-3 audit found the auto caps truncating coverage on the
    packed-scale configs; a benchmark number is only meaningful for a
    complete render.
    """
    cfg = dirt_tpu.suggest_raster_config(
        clipv, faces, size, size, clip=clip)
    bg = jnp.zeros((size, size, 3), jnp.float32)
    colors = jnp.zeros((jnp.asarray(clipv).shape[0], 3), jnp.float32)
    _, _, _, ovf = dirt_tpu.rasterise_with_aux(
        bg, clipv, colors, faces, config=cfg, clip=clip)
    assert not bool(ovf), "bench config must render untruncated"
    return cfg


def config1():
    size = 64
    verts = jnp.array([[-0.5, -0.5, 0, 1], [0.5, -0.5, 0, 1],
                       [0.0, 0.6, 0, 1]], jnp.float32)
    colors = jnp.ones((3, 1), jnp.float32)
    faces = jnp.array([[0, 1, 2]], jnp.int32)
    bg = jnp.zeros((size, size, 1), jnp.float32)
    w = _weights(size, 1)
    fwd = lambda v: dirt_tpu.rasterise(bg, v, colors, faces)
    loss = lambda v: jnp.sum(fwd(v) * w)
    _report("config1 single-tri flat ortho 64^2", size, fwd, (verts,),
            loss, (verts,))


def _posed(verts_obj, pose=(0.4, 0.3, 0.0), tz=-3.0):
    mv = matrices.compose(
        matrices.rodrigues(jnp.asarray(pose, jnp.float32)),
        matrices.translation(jnp.array([0.0, 0.0, tz])),
    )
    proj = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    return matrices.transform_homogeneous(
        jnp.asarray(verts_obj), matrices.compose(mv, proj))


def config2():
    size = 256
    verts_obj, faces = mesh.cube()
    clip = _posed(verts_obj)
    colors = jnp.asarray(
        np.random.RandomState(0).rand(len(verts_obj), 3), jnp.float32)
    bg = jnp.zeros((size, size, 3), jnp.float32)
    w = _weights(size, 3)
    faces = jnp.asarray(faces)
    fwd = lambda c, co: dirt_tpu.rasterise(bg, c, co, faces)
    loss = lambda c, co: jnp.sum(fwd(c, co) * w)
    _report("config2 cube zbuffer perspective 256^2", size,
            fwd, (clip, colors), loss, (clip, colors))


def config3():
    size = 512
    verts_obj, faces, uvs = mesh.uv_sphere(n_lat=24, n_lon=48)
    clip = _posed(verts_obj)
    texture = jnp.asarray(mesh.checkerboard_texture(128, 10, 3))
    faces = jnp.asarray(faces)
    uvs = jnp.asarray(uvs)
    bg = jnp.zeros((size, size, 3), jnp.float32)
    w = _weights(size, 3)

    rcfg = _honest(clip, faces, size)

    def render(clip, tex):
        gb = render_gbuffer(clip, faces, {"uv": uvs}, size, size,
                            config=rcfg)
        img = dirt_tpu.core.texture.sample_texture(tex, gb["uv"])
        return img * gb["mask"]

    loss = lambda c, tex: jnp.sum(render(c, tex) * w)
    _report("config3 textured UV + bilinear grads 512^2", size,
            render, (clip, texture), loss, (clip, texture))


def config4():
    size = 512
    verts_obj, faces, _ = mesh.uv_sphere(n_lat=24, n_lon=48)
    faces = jnp.asarray(faces)
    w = _weights(size, 3)
    bg = jnp.zeros((size, size, 3), jnp.float32)
    proj = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    rcfg = _honest(_posed(verts_obj), faces, size)

    def render(light, pose):
        mv = matrices.compose(
            matrices.rodrigues(pose),
            matrices.translation(jnp.array([0.0, 0.0, -3.0])),
        )
        world = matrices.transform_homogeneous(
            jnp.asarray(verts_obj), mv)[..., :3]
        normals = lighting.vertex_normals(world, faces)
        shaded = lighting.diffuse_directional(
            normals, jnp.ones((len(world), 3), jnp.float32),
            light / jnp.linalg.norm(light), jnp.ones(3),
        ) + lighting.specular_directional(
            world, normals, jnp.ones((len(world), 3), jnp.float32),
            jnp.zeros(3), light / jnp.linalg.norm(light), jnp.ones(3), 24.0,
        )
        clip = matrices.transform_homogeneous(world, proj)
        return dirt_tpu.rasterise(bg, clip, shaded, faces, config=rcfg)

    light = jnp.array([0.3, 0.8, 0.52])
    pose = jnp.array([0.4, 0.3, 0.0])
    loss = lambda l, p: jnp.sum(render(l, p) * w)
    _report("config4 lit lambert+specular grads 512^2", size,
            render, (light, pose), loss, (light, pose))


def config5():
    size = 1024
    verts_obj, faces, uvs = mesh.uv_sphere(n_lat=72, n_lon=72)
    faces = jnp.asarray(faces)
    uvs = jnp.asarray(uvs)
    texture = jnp.asarray(mesh.checkerboard_texture(128, 10, 3))
    proj = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    light = jnp.array([0.35, 0.75, 0.56])
    light = light / jnp.linalg.norm(light)
    w = _weights(size, 3)
    rcfg = _honest(_posed(verts_obj), faces, size)

    def render(verts, pose):
        mv = matrices.compose(
            matrices.rodrigues(pose),
            matrices.translation(jnp.array([0.0, 0.0, -3.0])),
        )
        world = matrices.transform_homogeneous(verts, mv)[..., :3]
        normals = lighting.vertex_normals(world, faces)
        clip = matrices.transform_homogeneous(world, proj)
        gb = render_gbuffer(
            clip, faces,
            {"position": world, "normal": normals, "uv": uvs},
            size, size, config=rcfg,
        )
        return shade_deferred(
            gb, light, jnp.ones(3), ambient=0.12, texture=texture,
            camera_position=jnp.zeros(3), shininess=24.0,
        )

    verts = jnp.asarray(verts_obj)
    pose = jnp.array([0.4, 0.3, 0.0])
    loss = lambda v, p: jnp.sum(render(v, p) * w)
    _report("config5 deferred 10k-tri inverse 1024^2", size,
            render, (verts, pose), loss, (verts, pose))


if __name__ == "__main__":
    print(f"# backend: {jax.default_backend()}")
    config1()
    config2()
    config3()
    config4()
    config5()
