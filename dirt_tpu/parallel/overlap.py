"""Gradient-overlapped collectives: row-banded backward + per-band psum.

SURVEY.md section 5 (distributed comm): the parameter-grad all-reduce
should run *while* the backward is still computing pixels. shard_map's
automatic transpose emits ONE psum after the whole backward; this module
restructures the slab backward into ``n_chunks`` row bands, each emitting
its own ``psum`` of the partial parameter gradients — giving XLA a
dependency graph where band k's collective can overlap band k+1's
compute. (The reference is single-GPU — no analogue.)

Verified on a virtual CPU mesh (``tests/test_overlap.py``): banded +
overlapped gradients == the unsharded ``jax.grad``. Whether the overlap
pays over NVLink is not measured.

Design notes:

* The forward runs once per slab (any engine). The backward's pixel
  cotangent pass (`raster_bwd.pixel_cotangents_core`) is evaluated per
  row band on SLICED arrays — boundary pairs whose two pixels fall in
  different bands (or different slabs) are still each counted exactly
  once, because the neighbor maps are precomputed on the halo-extended
  slab (:func:`_halo_neighbor_maps`) and sliced along with the band:
  the band owning the pair's front pixel sees the back pixel's data in
  its neighbor maps.
* Each band's per-face plane cotangents are `lax.psum`'d immediately;
  the summed rows then reduce to parameter space once, through the SAME
  `jax.vjp` chain as the one-shot path (setup_planes -> screen gather ->
  vertices). Summing psum'd bands equals psum'd sums (the one-shot
  gradient) exactly up to f32 reassociation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dirt_tpu.ops.raster import RasterConfig, _forward_impl
from dirt_tpu.ops.raster_bwd import (
    anchor_cotangents,
    face_rows,
    neighbor_maps,
    pixel_cotangents_core,
    stack_face_columns,
    unpack_face_rows,
)
from dirt_tpu.ops.triangle_setup import screen_from_clip, setup_planes
from dirt_tpu.parallel.sharding import _exchange_halo_rows


def _halo_neighbor_maps(fid, zbuf, pixels, grad_pixels, axis):
    """:func:`neighbor_maps` of this slab with its halo rows spliced in.

    The maps are computed on arrays extended by one mesh-neighbor row on
    each side, then cut back to the slab's own rows: the vertical
    neighbor data of the slab's first and last rows comes from the
    adjacent devices, so every cross-slab boundary pair is evaluated
    (exactly once) by the device owning the pair's front pixel.
    """
    fid_e, zbuf_e, pixels_e, grad_e = _exchange_halo_rows(
        fid, zbuf, pixels, grad_pixels, axis
    )
    nbrs = neighbor_maps(
        fid_e, zbuf_e, jnp.transpose(pixels_e, (2, 0, 1)),
        jnp.transpose(grad_e, (2, 0, 1)),
    )
    return [tuple(m[1:-1] for m in n) for n in nbrs]


def _band_face_rows(geo, att, fid_b, zbuf_b, pix_b, grad_b, nbrs_b, y0,
                    num_faces: int):
    """Per-face cotangent rows for one row band (pure-JAX engine).

    Mirrors ``raster_bwd.backward_jax`` but on row-sliced arrays with
    externally supplied neighbor maps and a global row offset ``y0``
    (band rows are slab-local ``y0 .. y0 + band_h``).
    Returns (d_geo [F, 24], d_att [F, 3C]) WITHOUT anchor
    cotangents (derived once after summing bands).
    """
    band_h, width = fid_b.shape
    covered = fid_b >= 0
    safe_fid = jnp.maximum(fid_b, 0)
    g16cf = jnp.transpose(geo[safe_fid], (2, 0, 1))
    pix_cf = jnp.transpose(pix_b, (2, 0, 1))
    grad_cf = jnp.transpose(grad_b, (2, 0, 1))

    col = jnp.arange(width, dtype=jnp.float32) + 0.5
    row = y0 + jnp.arange(band_h, dtype=jnp.float32) + 0.5
    xg = jnp.broadcast_to(col[None, :], (band_h, width))
    yg = jnp.broadcast_to(row[:, None], (band_h, width))

    d_geo_cols, d_att_cols = pixel_cotangents_core(
        g16cf, covered, fid_b, zbuf_b, pix_cf, grad_cf, nbrs_b, xg, yg
    )
    cot = stack_face_columns(d_geo_cols, d_att_cols, covered)
    return unpack_face_rows(face_rows(cot, fid_b, covered, num_faces))


def overlapped_loss_and_grads(
    background, vertices, vertex_colors, faces, target, mesh,
    axis: str = "tiles", config: RasterConfig | None = None,
    n_chunks: int = 2,
):
    """L2 render loss + gradients through :func:`rasterise_overlapped`.

    Args:
        background / target: [H, W, C] (sharded over rows by ``axis``).
        vertices: [V, 4] clip space (replicated); vertex_colors [V, C].
        faces: [F, 3] int32 static.
        mesh: Mesh containing ``axis``; n_chunks: row bands per slab.
    Returns:
        (loss [], d_vertices [V, 4], d_colors [V, C], d_background
        [H, W, C]). Gradients equal ``jax.grad`` of
        ``sum((rasterise(...) - target)**2)`` with ``clip=False``.
    """
    target = jnp.asarray(target, jnp.float32)

    def loss(bg, verts, cols):
        img = rasterise_overlapped(
            bg, verts, cols, faces, mesh, axis, config, n_chunks
        )
        return jnp.sum((img - target) ** 2)

    value, (d_bg, d_verts, d_cols) = jax.value_and_grad(
        loss, argnums=(0, 1, 2)
    )(
        jnp.asarray(background, jnp.float32),
        jnp.asarray(vertices, jnp.float32),
        jnp.asarray(vertex_colors, jnp.float32),
    )
    return value, d_verts, d_cols, d_bg


def rasterise_overlapped(
    background, vertices, vertex_colors, faces, mesh, axis: str = "tiles",
    config: RasterConfig | None = None, n_chunks: int = 2,
):
    """Row-sharded render whose backward overlaps grad psums with compute.

    Functionally identical to ``parallel.sharding.rasterise_sharded``
    (same forward, same gradient semantics, arbitrary upstream
    cotangents), but the backward runs the pixel cotangent pass as
    ``n_chunks`` row bands of each slab (:func:`_band_face_rows`, as even
    as the slab height allows); each band's per-face plane cotangents are
    psum'd immediately, so band k's collective can run while band k + 1
    computes.
    """
    height, width, _ = background.shape
    n = mesh.shape[axis]
    config = (config or RasterConfig()).concrete(height // n)
    if height % (n * config.tile_h) != 0:
        raise ValueError(
            f"height {height} must divide devices*tile_h "
            f"({n}*{config.tile_h})"
        )
    faces = jnp.asarray(faces, jnp.int32)
    num_faces = faces.shape[0]
    slab_h = height // n
    n_chunks = max(1, min(n_chunks, slab_h))
    bounds = [round(k * slab_h / n_chunks) for k in range(n_chunks + 1)]
    shift = jnp.array([0.0, 1.0, 0.0, 0.0])

    def _face_data(verts, cols, row0):
        fv = screen_from_clip(verts, height, width)[faces] - shift * row0
        return fv, cols[faces]

    @jax.custom_vjp
    def overlapped_op(background, verts, cols):
        return _fwd(background, verts, cols)[0]

    def _fwd(background, verts, cols):
        def per_dev(bg_slab, verts, cols):
            row0 = (jax.lax.axis_index(axis) * slab_h).astype(jnp.float32)
            fv, fa = _face_data(verts, cols, row0)
            pixels, fid, zbuf, _ = _forward_impl(fv, fa, bg_slab, config)
            return pixels, fid, zbuf

        pixels, fid, zbuf = jax.shard_map(
            per_dev, mesh=mesh,
            in_specs=(P(axis), P(), P()),
            out_specs=(P(axis), P(axis), P(axis)),
            check_vma=False,
        )(jnp.asarray(background, jnp.float32), verts, cols)
        return pixels, (verts, cols, pixels, fid, zbuf)

    def _bwd(residuals, grad_pixels):
        verts, cols, pixels, fid, zbuf = residuals

        def per_dev(cot, pix, fid_s, zbuf_s, verts, cols):
            row0 = (jax.lax.axis_index(axis) * slab_h).astype(jnp.float32)

            def to_planes(verts, cols):
                geo, att, _ = setup_planes(*_face_data(verts, cols, row0))
                return geo, att

            (geo, att), vjp_planes = jax.vjp(to_planes, verts, cols)
            nbrs = _halo_neighbor_maps(fid_s, zbuf_s, pix, cot, axis)
            d_geo = jnp.zeros_like(geo)
            d_att = jnp.zeros_like(att)
            for y0, y1 in zip(bounds[:-1], bounds[1:]):
                rows = slice(y0, y1)
                d_geo_k, d_att_k = _band_face_rows(
                    geo, att, fid_s[rows], zbuf_s[rows], pix[rows],
                    cot[rows], [tuple(m[rows] for m in n) for n in nbrs],
                    float(y0), num_faces,
                )
                # The per-band collective, over per-face plane cotangents
                # (the same on every slab: planes are anchored, and a
                # slab's row shift has unit Jacobian): it can overlap the
                # next band's cotangent pass.
                d_geo = d_geo + jax.lax.psum(d_geo_k, axis)
                d_att = d_att + jax.lax.psum(d_att_k, axis)
            d_geo = anchor_cotangents(geo, att, d_geo, d_att)
            d_verts, d_cols = vjp_planes((d_geo, d_att))
            d_bg = jnp.where((fid_s >= 0)[..., None], 0.0, cot)
            return d_verts, d_cols, d_bg

        d_verts, d_cols, d_bg = jax.shard_map(
            per_dev, mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P()),
            out_specs=(P(), P(), P(axis)),
            check_vma=False,
        )(grad_pixels, pixels, fid, zbuf, verts, cols)
        return d_bg, d_verts, d_cols

    overlapped_op.defvjp(_fwd, _bwd)
    return overlapped_op(
        jnp.asarray(background, jnp.float32),
        jnp.asarray(vertices, jnp.float32),
        jnp.asarray(vertex_colors, jnp.float32),
    )
