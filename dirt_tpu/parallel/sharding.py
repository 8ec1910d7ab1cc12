"""Multi-chip rendering: image-tile (slab) sharding over a device mesh.

The reference is single-process, single-GPU (SURVEY.md section 2.3); this
module spreads one render over the cards of a host. Design (SURVEY.md
sections 5 and 7):

* The image's row axis is sharded over a mesh axis (default ``"tiles"``) —
  the renderer's analogue of sequence/context parallelism. Each device
  rasterizes its horizontal slab; vertices/faces/attributes are replicated
  (they are tiny next to pixel buffers).
* Geometry is *shifted*, not re-projected, per slab: subtracting the slab's
  first row from screen-space y renders global rows in local coordinates
  and leaves gradients untouched (translation has unit Jacobian).
* Backward: boundary (silhouette) gradients need 1-row halos — each
  adjacent-pixel pair crossing a slab boundary is computed by the device
  that owns the pair's *front* pixel, using ``jax.lax.ppermute`` to fetch
  the neighbor row of (fid, zbuf, pixels, grad). Parameter gradients
  (vertices, colors, lights, camera) are all-reduced by shard_map's
  transpose (a ``psum`` over the tile axis) automatically.
* A ``"data"`` mesh axis batches independent scenes (data parallelism).

Everything composes with ``jit``: XLA hands the collectives to NCCL. The
cards of one host reach each other all to all over NVLink, so the mesh
shape follows the algorithm alone.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dirt_tpu.ops.raster import RasterConfig, _forward_impl
from dirt_tpu.ops.raster_bwd import backward_jax
from dirt_tpu.ops.raster_fwd import BIG_Z
from dirt_tpu.ops.triangle_setup import screen_from_clip, setup_planes


def _exchange_halo_rows(fid, zbuf, pixels, grad_pixels, axis: str):
    """Fetch the neighbor boundary rows along the sharded row axis.

    Returns extended arrays with one halo row prepended and appended:
    [H+2, W, ...]. Devices at the mesh ends get sentinel halos (fid = -2,
    z = BIG_Z) marking the true image border.
    """
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)

    def from_prev(row):  # receive previous device's LAST row
        out = jax.lax.ppermute(
            row, axis, [(i, i + 1) for i in range(n - 1)]
        )
        return out

    def from_next(row):  # receive next device's FIRST row
        return jax.lax.ppermute(
            row, axis, [(i + 1, i) for i in range(n - 1)]
        )

    is_first = (idx == 0)
    is_last = (idx == n - 1)

    def ext(arr, fill):
        top = from_prev(arr[-1:])
        bottom = from_next(arr[:1])
        fill_arr = jnp.full_like(top, fill)
        top = jnp.where(is_first, fill_arr, top)
        bottom = jnp.where(is_last, jnp.full_like(bottom, fill), bottom)
        return jnp.concatenate([top, arr, bottom], axis=0)

    return (
        ext(fid, -2),
        ext(zbuf, BIG_Z),
        ext(pixels, 0.0),
        ext(grad_pixels, 0.0),
    )


def _make_slab_op(config: RasterConfig, axis: str, total_height: int):
    """custom_vjp slab rasterizer with halo-exchanged boundary gradients.

    Takes screen-space face data already shifted into slab-local rows, plus
    the slab's global first row (traced). The forward is the ordinary
    single-device path; the backward extends the slab by 1-row halos from
    mesh neighbors before the boundary-gradient pass.
    """

    @functools.partial(jax.custom_vjp, nondiff_argnums=())
    def slab_op(face_verts_local, face_attrs, bg_slab, row0):
        pixels, fid, zbuf, _ = _forward_impl(
            face_verts_local, face_attrs, bg_slab, config
        )
        return pixels, fid, zbuf

    def fwd(face_verts_local, face_attrs, bg_slab, row0):
        pixels, fid, zbuf, _ = _forward_impl(
            face_verts_local, face_attrs, bg_slab, config
        )
        out = (pixels, fid, zbuf)
        return out, (face_verts_local, face_attrs, *out, row0)

    def bwd(residuals, cotangents):
        face_verts_local, face_attrs, pixels, fid, zbuf, row0 = residuals
        grad_pixels = cotangents[0]
        slab_h = fid.shape[0]

        # Rows past the true image height are padding: remove them from the
        # pair graph entirely (matches the single-device crop semantics).
        rows = jnp.arange(slab_h)
        row_in_image = (row0 + rows) < total_height
        fid = jnp.where(row_in_image[:, None], fid, -2)
        zbuf = jnp.where(row_in_image[:, None], zbuf, BIG_Z)

        fid_e, zbuf_e, pixels_e, grad_e = _exchange_halo_rows(
            fid, zbuf, pixels, grad_pixels, axis
        )
        own = jnp.zeros((slab_h + 2,), bool).at[1:-1].set(True)
        own_mask = jnp.broadcast_to(own[:, None], fid_e.shape)

        # Extended-array row i is slab-local row i - 1 (halo at i = 0), so
        # express the geometry in extended coordinates by shifting screen y
        # down one row; the +1 translation has unit Jacobian, so the vjp of
        # this shifted setup chains gradients to the local vertices exactly.
        def planes_shifted(fv, fa):
            geo2, att2, _ = setup_planes(
                fv + jnp.array([0.0, 1.0, 0.0, 0.0]), fa
            )
            return geo2, att2

        (geo_shift, att_shift), vjp_shift = jax.vjp(
            planes_shifted, face_verts_local, face_attrs
        )
        # Halo rows are not owned: they supply the neighbor side of
        # cross-slab pairs and contribute nothing themselves.
        d_geo, d_att, d_bg_e = backward_jax(
            geo_shift, att_shift, fid_e, zbuf_e, pixels_e, grad_e,
            own_mask=own_mask,
        )
        d_fv, d_fa = vjp_shift((d_geo, d_att))
        d_bg = d_bg_e[1:-1]
        return d_fv, d_fa, d_bg, jnp.zeros_like(row0, dtype=jnp.float32)

    slab_op.defvjp(fwd, bwd)
    return slab_op


def slab_render(
    bg_slab, vertices, vertex_colors, faces, height: int, width: int,
    axis: str, config: RasterConfig | None = None,
):
    """Render this device's image slab. Must run inside a shard_map whose
    mesh contains ``axis`` (the image-row axis); composable with other mesh
    axes (e.g. a 'data' axis for scene batching) by named-axis scoping.

    Args:
        bg_slab: [H / n_axis, W, C] this device's background rows.
        vertices / vertex_colors: replicated [V, 4] / [V, C].
        faces: [F, 3] int32 (static contents).
        height, width: FULL image dimensions.
    Returns:
        [H / n_axis, W, C] this device's rendered rows (differentiable;
        boundary gradients are halo-exchanged over ``axis``).
    """
    config = (config or RasterConfig()).concrete(bg_slab.shape[0])
    faces = jnp.asarray(faces, jnp.int32)
    slab_h = bg_slab.shape[0]
    slab_op = _make_slab_op(config, axis, height)
    idx = jax.lax.axis_index(axis)
    row0 = (idx * slab_h).astype(jnp.float32)
    verts_screen = screen_from_clip(vertices, height, width)
    face_verts = verts_screen[faces]
    face_verts = face_verts - jnp.array([0.0, 1.0, 0.0, 0.0]) * row0
    face_attrs = vertex_colors[faces]
    pixels, _, _ = slab_op(face_verts, face_attrs, bg_slab, row0)
    return pixels


def rasterise_sharded(
    background, vertices, vertex_colors, faces, mesh, axis: str = "tiles",
    config: RasterConfig | None = None, overlap_chunks: int | None = None,
):
    """Tile-sharded equivalent of ``dirt_tpu.rasterise``.

    Args:
        background: [H, W, C]; H must be divisible by
            ``mesh.shape[axis] * config.tile_h`` (pad upstream if not).
        vertices: [V, 4] clip space (replicated).
        vertex_colors: [V, C] (replicated).
        faces: [F, 3] int32 (replicated, static).
        mesh: jax.sharding.Mesh containing ``axis``.
        axis: mesh axis name for the image rows, or a tuple of names
            (rows shard over their product, first name major).
        overlap_chunks: if set (and ``axis`` is a single name), the
            backward runs as that many row bands with a parameter-grad
            ``psum`` per band, so a band's collective can overlap the
            next band's compute (``parallel.overlap``). Gradients are
            unchanged up to f32 reassociation.
    Returns:
        [H, W, C] rendered image, sharded along rows; differentiable w.r.t.
        background, vertices, vertex_colors (parameter grads all-reduced).
    """
    if overlap_chunks is not None:
        from dirt_tpu.parallel.overlap import rasterise_overlapped

        if not isinstance(axis, str):
            raise ValueError("overlap_chunks needs a single-name axis")
        return rasterise_overlapped(
            background, vertices, vertex_colors, faces, mesh, axis,
            config, n_chunks=overlap_chunks,
        )
    height, width, _ = background.shape
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    config = (config or RasterConfig()).concrete(height // n)
    if height % (n * config.tile_h) != 0:
        raise ValueError(
            f"height {height} must be divisible by devices*tile_h "
            f"({n}*{config.tile_h})"
        )

    def slab_fn(bg_slab, verts, colors):
        return slab_render(
            bg_slab, verts, colors, faces, height, width, axis, config
        )

    fn = jax.shard_map(
        slab_fn,
        mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=P(axis),
        check_vma=False,  # pallas_call's out_shape carries no vma info
    )
    return fn(
        jnp.asarray(background, jnp.float32),
        jnp.asarray(vertices, jnp.float32),
        jnp.asarray(vertex_colors, jnp.float32),
    )
