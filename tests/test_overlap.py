"""Row-chunked, per-chunk-psum backward == unsharded gradients.

SURVEY.md section 5 / ROADMAP r2 #7: the overlap STRUCTURE (backward
split into row bands, each emitting its own parameter-grad psum) is
correctness-proven on the virtual 8-device mesh; whether the overlap pays
over NVLink needs several cards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import dirt_tpu
from dirt_tpu.ops.raster import RasterConfig
from dirt_tpu.parallel.overlap import overlapped_loss_and_grads

CFG = RasterConfig(tile_h=8, tile_w=128, bin_cap=64)


def _scene(seed=3, num_faces=24, num_verts=30, size=128):
    rng = np.random.RandomState(seed)
    verts = np.zeros((num_verts, 4), np.float32)
    verts[:, :2] = rng.uniform(-0.9, 0.9, (num_verts, 2))
    verts[:, 2] = rng.uniform(-0.5, 0.5, num_verts)
    verts[:, 3] = 1.0
    faces = rng.randint(0, num_verts, (num_faces, 3)).astype(np.int32)
    colors = rng.uniform(0, 1, (num_verts, 3)).astype(np.float32)
    bg = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    return tuple(
        jnp.asarray(a) for a in (verts, colors, faces, bg, target)
    )


def test_overlapped_grads_match_unsharded():
    verts, colors, faces, bg, target = _scene()

    def loss_single(verts, colors, bg):
        img = dirt_tpu.rasterise(
            bg, verts, colors, faces, config=CFG, clip=False
        )
        return jnp.sum((img - target) ** 2)

    l_ref, g_ref = jax.value_and_grad(
        loss_single, argnums=(0, 1, 2)
    )(verts, colors, bg)

    with Mesh(np.array(jax.devices()[:4]), ("tiles",)) as mesh:
        loss, d_v, d_c, d_bg = jax.jit(
            lambda v, c, b: overlapped_loss_and_grads(
                b, v, c, faces, target, mesh, "tiles", CFG, n_chunks=2
            )
        )(verts, colors, bg)

    np.testing.assert_allclose(float(loss), float(l_ref), rtol=1e-5)
    for got, want, name in zip(
        (d_v, d_c, d_bg), g_ref, ["verts", "colors", "bg"]
    ):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4,
            err_msg=name,
        )
    assert np.abs(np.asarray(g_ref[0])).max() > 0


def test_overlapped_chunk_count_invariance():
    """1-chunk (no overlap structure) == 4-chunk gradients exactly."""
    verts, colors, faces, bg, target = _scene(seed=9, size=64)
    with Mesh(np.array(jax.devices()[:2]), ("tiles",)) as mesh:
        outs = [
            jax.jit(
                lambda v, c, b, k=k: overlapped_loss_and_grads(
                    b, v, c, faces, target, mesh, "tiles", CFG,
                    n_chunks=k,
                )
            )(verts, colors, bg)
            for k in (1, 4)
        ]
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6
        )


PACKED_CFG = RasterConfig(
    tile_h=8, tile_w=128, engine="packed", expand_cap=128, budget=2048
)


@pytest.mark.slow
def test_production_overlapped_arbitrary_cotangents():
    """rasterise_sharded(overlap_chunks=N): packed fused backward, sliced
    into per-chunk psums, under an ARBITRARY downstream loss (custom_vjp,
    not the bespoke L2 helper) == single-device jax.grad."""
    from dirt_tpu.parallel.sharding import rasterise_sharded

    verts, colors, faces, bg, target = _scene(seed=5, size=64)
    w = jnp.asarray(
        np.random.RandomState(7).rand(64, 64, 3), jnp.float32
    )

    def loss_single(verts, colors, bg):
        img = dirt_tpu.rasterise(
            bg, verts, colors, faces, config=PACKED_CFG, clip=False
        )
        return jnp.sum(jnp.sin(img * 2.0) * w + img * target)

    g_ref = jax.grad(loss_single, argnums=(0, 1, 2))(verts, colors, bg)

    with Mesh(np.array(jax.devices()[:4]), ("tiles",)) as mesh:
        def loss_sharded(verts, colors, bg):
            img = rasterise_sharded(
                bg, verts, colors, faces, mesh, "tiles", PACKED_CFG,
                overlap_chunks=3,
            )
            return jnp.sum(jnp.sin(img * 2.0) * w + img * target)

        g_s = jax.jit(
            jax.grad(loss_sharded, argnums=(0, 1, 2))
        )(verts, colors, bg)

    for got, want, name in zip(g_s, g_ref, ["verts", "colors", "bg"]):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4,
            err_msg=name,
        )
    assert np.abs(np.asarray(g_ref[0])).max() > 0


def _summation_scale(verts, colors, faces, bg, target, config):
    """Per-entry sum of |terms| of the (verts, colors) gradients of
    ``sum((rasterise(...) - target)**2)``, single device, clip off.

    Each face's plane cotangents are sums of per-pixel terms; the vertex and
    colour gradients are a fixed linear map of those sums. Summing the
    terms in another order (other row bands, other slabs) moves an entry by
    a few f32 eps times the sum of |terms| pushed through |map|; one pair
    counted twice or missed moves it by a whole term.
    """
    from dirt_tpu.ops.raster import _forward_impl
    from dirt_tpu.ops.raster_bwd import (
        assemble_face_gradients, face_cotangent_columns, face_rows,
    )
    from dirt_tpu.ops.triangle_setup import screen_from_clip, setup_planes

    height, width, _ = bg.shape

    def planes(v, c):
        return setup_planes(screen_from_clip(v, height, width)[faces],
                            c[faces])[:2]

    (geo, att), vjp_planes = jax.vjp(planes, verts, colors)
    pix, fid, zbuf, _ = _forward_impl(
        screen_from_clip(verts, height, width)[faces], colors[faces], bg,
        config.concrete(height),
    )
    cot, covered = face_cotangent_columns(
        geo, fid, zbuf, pix, 2.0 * (pix - target)
    )
    abs_rows = face_rows(jnp.abs(cot), fid, covered, faces.shape[0])
    jac = jax.jacobian(
        lambda rows: vjp_planes(assemble_face_gradients(geo, att, rows))
    )(abs_rows)
    return [np.asarray(jnp.einsum("ij...,...->ij", jnp.abs(m), abs_rows))
            for m in jac]


@pytest.mark.slow
def test_production_overlapped_chunk_invariance():
    """overlap_chunks=1 == overlap_chunks=4 == one device, packed engine.

    Bands and slabs only re-order each face's f32 sums, so every vertex and
    colour entry agrees within 4 eps x its sum of |terms|
    (:func:`_summation_scale`; about 1.2 eps is reached), and the
    background gradient, which sums nothing, agrees exactly."""
    from dirt_tpu.parallel.overlap import rasterise_overlapped

    verts, colors, faces, bg, target = _scene(seed=11, size=64)

    def loss_single(v, c, b):
        img = dirt_tpu.rasterise(b, v, c, faces, config=PACKED_CFG,
                                 clip=False)
        return jnp.sum((img - target) ** 2)

    outs = [jax.jit(jax.grad(loss_single, argnums=(0, 1, 2)))(
        verts, colors, bg)]
    with Mesh(np.array(jax.devices()[:2]), ("tiles",)) as mesh:
        for k in (1, 4):
            def loss(v, c, b, k=k):
                img = rasterise_overlapped(
                    b, v, c, faces, mesh, "tiles", PACKED_CFG, n_chunks=k
                )
                return jnp.sum((img - target) ** 2)

            outs.append(
                jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(verts, colors, bg)
            )
    scale = _summation_scale(verts, colors, faces, bg, target, PACKED_CFG)
    eps = np.finfo(np.float32).eps
    for i, j in ((0, 1), (0, 2), (1, 2)):
        for a, b, s, name in zip(outs[i][:2], outs[j][:2], scale,
                                 ("verts", "colors")):
            err = np.abs(np.asarray(a) - np.asarray(b))
            assert np.all(err <= 4 * eps * s), (
                f"{name} ({i} vs {j}): max |diff| {float(err.max())}"
            )
        np.testing.assert_array_equal(np.asarray(outs[i][2]),
                                      np.asarray(outs[j][2]))
