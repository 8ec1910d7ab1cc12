"""Triangle-list (face) sharding across a mesh axis — the TP analogue.

SURVEY.md section 2.3 names per-chip triangle-list splitting as this
framework's closest analogue of tensor parallelism (VERDICT round 1,
missing #2): for meshes too large to bin/setup on every chip, the face
list is split across a mesh axis; every chip rasterizes ITS faces into a
full-image (z, global-face-id, color) partial and the partials composite
by a minimum-depth reduction with the single-device z-tie rule (lowest
global face id wins), so the sharded render is pixel-exact vs one device.

Compositing is two ``pmin`` collectives (z, then id-among-z
-winners) plus one masked ``psum`` for the winner's colors — O(H*W) bytes
per chip, no triangle-count-dependent communication.

Backward (custom_vjp, round 4 — rows x faces co-sharding): each chip
runs the per-pixel cotangent pass over only ITS ROW BAND of the
composite (H / n rows + 1-row ppermute halos, so cross-band and
cross-shard occlusion pairs are each seen exactly once by the band
owning the pair's front pixel), accumulating cotangent rows for ALL
global faces that appear in the band; a ``psum_scatter`` over the face
axis then routes each face's summed gradient row to its owning shard
(O(F * 27) bytes — tiny next to pixel buffers). Per-chip backward
compute is O(H * W / n), shrinking with the shard count, where the
round-2/3 implementation replicated the full-image pass on every chip
(round-3 VERDICT weak #5). Per-face plane data for the band's gather is
one [F/n, 24] all_gather (also tiny).
"""

from __future__ import annotations

import functools

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
from dirt_tpu.ops.raster_fwd import BIG_Z
from dirt_tpu.ops.triangle_setup import screen_from_clip, setup_planes
from dirt_tpu.parallel.sharding import _exchange_halo_rows

_BIG_ID = jnp.int32(2**30)


def _band_face_rows(geo_all, att_all, fid_e, zbuf_e, pix_e, grad_e,
                    own_mask, y0, num_faces_global: int):
    """Cotangent rows for one halo-extended row band, to GLOBAL face ids.

    Mirrors ``raster_bwd.backward_jax`` on the [band_h + 2, W] extended
    arrays, with pixel y coordinates anchored at global row ``y0 - 1``
    (the geometry is in global screen coordinates — band-local coordinates
    would corrupt every dy term). Halo rows supply neighbor-side data for
    boundary pairs but never act as the front/interior pixel
    (``own_mask``). Returns (d_geo [F_global, 24], d_att [F_global, 3C])
    WITHOUT anchor cotangents (applied per-face after the psum_scatter).
    """
    height_e, width = fid_e.shape
    covered = (fid_e >= 0) & own_mask
    safe_fid = jnp.maximum(fid_e, 0)
    g16cf = jnp.transpose(geo_all[safe_fid], (2, 0, 1))
    pix_cf = jnp.transpose(pix_e, (2, 0, 1))
    grad_cf = jnp.transpose(grad_e, (2, 0, 1))

    col = jnp.arange(width, dtype=jnp.float32) + 0.5
    row = (y0 - 1.0) + jnp.arange(height_e, dtype=jnp.float32) + 0.5
    xg = jnp.broadcast_to(col[None, :], (height_e, width))
    yg = jnp.broadcast_to(row[:, None], (height_e, width))

    nbrs = neighbor_maps(fid_e, zbuf_e, pix_cf, grad_cf)
    d_geo_cols, d_att_cols = pixel_cotangents_core(
        g16cf, covered, fid_e, zbuf_e, pix_cf, grad_cf, nbrs, xg, yg
    )
    cot = stack_face_columns(d_geo_cols, d_att_cols, covered)
    return unpack_face_rows(
        face_rows(cot, fid_e, covered, num_faces_global)
    )


def _make_face_shard_op(config: RasterConfig, axis,
                        height: int, width: int):
    """custom_vjp: local faces -> composited full image (+ aux maps)."""

    @functools.partial(jax.custom_vjp, nondiff_argnums=())
    def shard_op(fv_local, fa_local, background):
        out, _ = _fwd(fv_local, fa_local, background)
        return out

    def _fwd(fv_local, fa_local, background):
        f_local = fv_local.shape[0]
        channels = fa_local.shape[-1]
        offset = jax.lax.axis_index(axis) * f_local
        neutral = jnp.zeros((height, width, channels), jnp.float32)
        pix_l, fid_l, z_l, _bins = _forward_impl(
            fv_local, fa_local, neutral, config
        )
        covered_l = fid_l >= 0
        gid = jnp.where(covered_l, fid_l + offset, _BIG_ID)
        zkey = jnp.where(covered_l, z_l, BIG_Z)

        # Lexicographic (z, gid) min across the face axis: single-device
        # tie rule (lowest global face id wins at equal z).
        zmin = jax.lax.pmin(zkey, axis)
        gid_at = jnp.where(zkey == zmin, gid, _BIG_ID)
        gmin = jax.lax.pmin(gid_at, axis)
        mine = (zkey == zmin) & (gid == gmin)

        covered = gmin < _BIG_ID
        pix = jax.lax.psum(jnp.where(mine[..., None], pix_l, 0.0), axis)
        # Composite over the background INSIDE the op: the boundary
        # gradient model needs the true image values and the upstream
        # gradient at BACKGROUND pixels too (silhouette pairs), so the
        # differentiation boundary must see the full image.
        pix = jnp.where(covered[..., None], pix, background)
        fid_g = jnp.where(covered, gmin, -1)
        zbuf = jnp.where(covered, zmin, BIG_Z)
        out = (pix, fid_g, zbuf)
        return out, (fv_local, fa_local, pix, fid_g, zbuf)

    def _bwd(residuals, cotangents):
        fv_local, fa_local, pix, fid_g, zbuf = residuals
        cot = cotangents[0]
        f_local = fv_local.shape[0]
        n = jax.lax.axis_size(axis)
        i = jax.lax.axis_index(axis)
        offset = i * f_local
        num_global = f_local * n
        band_h = height // n     # caller enforces height % n == 0
        r0 = i * band_h

        def planes(fv, fa):
            geo, att, _ = setup_planes(fv, fa)
            return geo, att

        (geo, att), vjp_fn = jax.vjp(planes, fv_local, fa_local)
        # Per-face plane rows of ALL shards, for the band's fid gather
        # (any global face can win pixels in any band). [F_global, 24] —
        # tiny next to pixel buffers.
        geo_all = jax.lax.all_gather(geo, axis, axis=0, tiled=True)
        att_all = jax.lax.all_gather(att, axis, axis=0, tiled=True)

        # This shard's row band of the composite. The composite maps are
        # replicated VALUES (post-pmin/psum); the cotangent is nonzero
        # exactly on this band because the caller slices slab == band
        # rows out of the replicated composite, so no psum of the full
        # image gradient is needed — only 1-row ppermute halos for
        # boundary pairs crossing band boundaries.
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, r0, band_h, 0)
        fid_b, zbuf_b, pix_b, grad_b = sl(fid_g), sl(zbuf), sl(pix), sl(cot)
        fid_e, zbuf_e, pix_e, grad_e = _exchange_halo_rows(
            fid_b, zbuf_b, pix_b, grad_b, axis
        )
        own = jnp.zeros((band_h + 2,), bool).at[1:-1].set(True)
        own_mask = jnp.broadcast_to(own[:, None], fid_e.shape)

        d_geo_g, d_att_g = _band_face_rows(
            geo_all, att_all, fid_e, zbuf_e, pix_e, grad_e, own_mask,
            r0.astype(jnp.float32), num_global,
        )
        # Route each face's summed gradient row to its owning shard: the
        # face axis is contiguous-sharded (shard i owns global ids
        # [i * f_local, (i+1) * f_local)), exactly psum_scatter's tiled
        # layout.
        d_geo_loc = jax.lax.psum_scatter(
            d_geo_g, axis, scatter_dimension=0, tiled=True
        )
        d_att_loc = jax.lax.psum_scatter(
            d_att_g, axis, scatter_dimension=0, tiled=True
        )
        d_geo_loc = anchor_cotangents(geo, att, d_geo_loc, d_att_loc)
        d_fv, d_fa = vjp_fn((d_geo_loc, d_att_loc))

        # Background gradient: this band's rows only (composite
        # coverage); the all_gather transpose in the caller psum-scatters
        # across shards, and each row is covered by exactly one band.
        d_bg_band = jnp.where((fid_b >= 0)[..., None], 0.0, grad_b)
        d_bg = jax.lax.dynamic_update_slice_in_dim(
            jnp.zeros_like(cot), d_bg_band, r0, 0
        )
        return d_fv, d_fa, d_bg

    shard_op.defvjp(_fwd, _bwd)
    return shard_op


def rasterise_face_sharded(
    background, vertices, vertex_colors, faces, mesh, axis: str = "faces",
    config: RasterConfig | None = None,
):
    """Face-sharded equivalent of ``dirt_tpu.rasterise`` (pixel-exact).

    Args:
        background: [H, W, C] (replicated).
        vertices: [V, 4] clip space (replicated).
        vertex_colors: [V, C] (replicated).
        faces: [F, 3] int32; F must be divisible by ``mesh.shape[axis]``
            (pad with degenerate faces upstream if needed).
        mesh: Mesh containing ``axis``.
    Returns:
        [H, W, C] image equal to the single-device render; differentiable
        w.r.t. background, vertices, vertex_colors (vertex gradients
        assemble from the shards' disjoint per-face contributions).
    """
    height, width, channels = background.shape
    config = (config or RasterConfig()).concrete(height)
    faces = jnp.asarray(faces, jnp.int32)
    num_faces = faces.shape[0]
    n = mesh.shape[axis]
    if num_faces % n:
        raise ValueError(f"faces ({num_faces}) must divide by {n}")
    f_local = num_faces // n

    shard_op = _make_face_shard_op(config, axis, height, width)

    n_ax = mesh.shape[axis]
    slab = height // n_ax

    def device_fn(fv_shard, fa_shard, bg_slab):
        # The background also enters SHARDED (row slabs) and is
        # re-assembled with all_gather: primitive transposes (gather <->
        # psum+slice) make both image and background cotangents exact
        # without relying on shard_map's replicated-operand conventions.
        bg = jax.lax.all_gather(bg_slab, axis, axis=0, tiled=True)
        pix, fid_g, zbuf = shard_op(fv_shard[0], fa_shard[0], bg)
        i = jax.lax.axis_index(axis)
        return jax.lax.dynamic_slice_in_dim(pix, i * slab, slab, 0)

    verts_screen = screen_from_clip(
        jnp.asarray(vertices, jnp.float32), height, width
    )
    face_verts = verts_screen[faces].reshape(n, f_local, 3, 4)
    face_attrs = jnp.asarray(vertex_colors, jnp.float32)[faces].reshape(
        n, f_local, 3, channels
    )

    if height % n:
        raise ValueError(f"height ({height}) must divide by {n}")
    fn = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return fn(
        face_verts, face_attrs, jnp.asarray(background, jnp.float32)
    )
