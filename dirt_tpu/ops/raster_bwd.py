"""Backward pass: exact interior gradients + occlusion-aware edge gradients.

Equivalent of the reference's CUDA/GL gradient op
(``csrc/rasterise_grad_egl.cpp`` — REGISTER_OP("RasteriseGrad"); SURVEY.md
sections 2.1 and 3.2). Semantics (shared with the oracle in
``dirt_tpu/ref/slowref.py`` — see its module docstring for the derivation):

* Interior: gradient of ``num_plane / den_plane`` w.r.t. the plane
  coefficients at fixed coverage (exact; chained to screen vertices and
  attributes through ``jax.vjp`` of ``setup_planes``).
* Boundary: for each adjacent pixel pair with differing face ids, the
  frontmost face's crossing edge receives the intensity-difference x
  edge-motion term ``d(a,b,c0) += S * (x*-ax, y*-ay, 1) / (|a|+|b|)``
  (anchored plane form — see triangle_setup).

Anchor cotangents: every plane depends on the anchor (ax, ay) only through
``c_global = c0 - a*ax - b*ay``, so ``d_ax = -sum_p a_p * d_c0_p`` and
``d_ay = -sum_p b_p * d_c0_p`` over all planes of the face (edges, z, den,
attribute numerators). They are derived after the per-face scatter.

Shape of the computation (the same as the reference's CUDA backward: one
thread per pixel, each reading its face's data and adding into the
gradients): a row gather of each pixel's face planes, the per-pixel
cotangent fields, and one ``segment_sum`` onto faces. Per-pixel cotangents
are accumulated as individual [H, W] columns and stacked once — in-place
``.at[col].add`` updates on an [H, W, 24] array would make XLA materialize
the full array per update. Interior terms use the identity
``num_c = pixels_c / recip`` so no attribute-plane gather is needed; only
the geometry columns are gathered by face id.

On the GPU ``segment_sum`` lowers to atomic adds whose order changes from
run to run, so gradients agree with the CPU and with the float64 oracle
to f32 summation-order tolerance, not bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dirt_tpu.ops.raster_fwd import BIG_Z
from dirt_tpu.ops.triangle_setup import (
    GEO_AX,
    GEO_AY,
    GEO_DEN,
    GEO_EDGE,
    GEO_WIDTH,
    GEO_Z,
)

A_EPS = 1e-12


def _shift(arr, axis, offset, fill):
    """Shift ``arr`` by ``offset`` along ``axis`` filling vacated slots."""
    rolled = jnp.roll(arr, -offset, axis=axis)
    idx = jnp.arange(arr.shape[axis])
    valid = (idx + offset >= 0) & (idx + offset <= arr.shape[axis] - 1)
    shape = [1] * arr.ndim
    shape[axis] = arr.shape[axis]
    valid = valid.reshape(shape)
    return jnp.where(valid, rolled, fill)


def boundary_cases():
    """The four neighbor-pair orientations of the edge term.

    Each entry is (axis, offset, horizontal, strict): the OWN pixel is kept
    as the front pixel and ``offset`` points at the back pixel along
    ``axis``. Tie rule matches the oracle: for a horizontal pair the left
    pixel is front iff z_left < z_right (so own-front with the back pixel on
    the left requires z_own <= z_left); likewise vertically with top/down.
    """
    return [
        (1, +1, True, True),    # back = right neighbor: front iff z < z_r
        (1, -1, True, False),   # back = left:  front iff z <= z_l
        (0, +1, False, True),   # back = below: front iff z < z_d
        (0, -1, False, False),  # back = above: front iff z <= z_u
    ]


def neighbor_maps(fid, zbuf, pixels_cf, grad_cf):
    """Per-direction neighbor data for the boundary term (XLA shifts).

    Returns a list over :func:`boundary_cases` of (nfid, nz, sval):
    the neighbor's face id / depth, and the pair's shared intensity
    gradient ``sval = 0.5 * sum_c (g + g_nbr)(p - p_nbr)``. Out-of-image
    neighbors get fid -2 / z BIG_Z / sval 0 (excluded pairs).
    """
    out = []
    for axis, offset, _, _ in boundary_cases():
        nfid = _shift(fid, axis, offset, -2)
        nz = _shift(zbuf, axis, offset, BIG_Z)
        npix = _shift(pixels_cf, axis + 1, offset, 0.0)
        ng = _shift(grad_cf, axis + 1, offset, 0.0)
        sval = 0.5 * jnp.sum((grad_cf + ng) * (pixels_cf - npix), axis=0)
        out.append((nfid, nz, sval))
    return out


def pixel_cotangents(g16cf, covered, fid, zbuf, pixels_cf, grad_cf):
    """Per-pixel cotangent columns w.r.t. the owning face's planes.

    All multi-channel inputs are channels-FIRST: slicing the leading
    dimension is free, whereas column slices of an [H, W, 24] array are
    strided reads.

    Args:
        g16cf: [GEO_WIDTH>=17, H, W] the owning face's geometry row per
            pixel (any gather/reconstruction; only rows :17 are read).
        covered: [H, W] bool — pixels that own a face AND are owned by this
            shard (non-owned halo pixels only supply neighbor-side data).
        fid: [H, W] int32; zbuf: [H, W] f32.
        pixels_cf, grad_cf: [C, H, W] forward output / upstream cotangent.
    Returns:
        (d_geo_cols, d_att_cols): lists of [H, W] arrays — the per-pixel
        cotangents for geometry plane columns 0..16 (anchor columns are
        zeros; they are derived per-face later) and attribute columns
        0..3C-1.
    """
    height, width = fid.shape
    col = jnp.arange(width, dtype=jnp.float32) + 0.5
    row = jnp.arange(height, dtype=jnp.float32) + 0.5
    xg = jnp.broadcast_to(col[None, :], (height, width))
    yg = jnp.broadcast_to(row[:, None], (height, width))
    nbrs = neighbor_maps(fid, zbuf, pixels_cf, grad_cf)
    return pixel_cotangents_core(
        g16cf, covered, fid, zbuf, pixels_cf, grad_cf, nbrs, xg, yg
    )


def pixel_cotangents_core(g16cf, covered, fid_pair, zbuf, pixels_cf,
                          grad_cf, nbrs, xg, yg):
    """Shift-free cotangent engine over precomputed neighbor data.

    Args:
        g16cf: indexable per-plane maps (``g16cf[k]`` -> [H, W]); columns
            follow the geo layout of ``triangle_setup``.
        fid_pair: [H, W] int32 face ids, used for the fid != nfid pair test.
        nbrs: list over :func:`boundary_cases` of (nfid, nz, sval) from
            :func:`neighbor_maps`, computed by the caller so a row band or
            a mesh slab sees the neighbors across its border.
        xg, yg: [H, W] global pixel-center coordinates.
    """
    height, width = xg.shape
    channels = pixels_cf.shape[0]

    dxg = xg - g16cf[GEO_AX]
    dyg = yg - g16cf[GEO_AY]

    zero = jnp.zeros((height, width), jnp.float32)
    d_geo = [zero] * GEO_WIDTH
    d_att = []

    # ---- interior term -------------------------------------------------
    den = (
        g16cf[GEO_DEN] * dxg
        + g16cf[GEO_DEN + 1] * dyg
        + g16cf[GEO_DEN + 2]
    )
    recip = jnp.where(covered, 1.0 / den, 0.0)
    s_acc = zero
    for c in range(channels):
        g_c = grad_cf[c]
        w_c = jnp.where(covered, g_c * recip, 0.0)
        d_att += [w_c * dxg, w_c * dyg, w_c]
        # pixels_c == num_c * recip exactly on covered pixels, so
        # s_acc = sum_c g_c * num_c = sum_c g_c * pixels_c / recip and
        # t_den = -recip^2 * s_acc = -recip * sum_c g_c * pixels_c.
        s_acc = s_acc + g_c * pixels_cf[c]
    t_den = jnp.where(covered, -recip * s_acc, 0.0)
    d_geo[GEO_DEN] = t_den * dxg
    d_geo[GEO_DEN + 1] = t_den * dyg
    d_geo[GEO_DEN + 2] = t_den

    # ---- boundary term --------------------------------------------------
    # Per-face edge data at the own pixel.
    a_e = [g16cf[GEO_EDGE + 3 * j] for j in range(3)]
    b_e = [g16cf[GEO_EDGE + 3 * j + 1] for j in range(3)]
    e_own = [
        a_e[j] * dxg + b_e[j] * dyg + g16cf[GEO_EDGE + 3 * j + 2]
        for j in range(3)
    ]

    acc_edge = [[zero, zero, zero] for _ in range(3)]  # [edge][a|b|c0]
    for case, (axis, offset, horizontal, strict) in enumerate(
        boundary_cases()
    ):
        nfid, nz, s_val = nbrs[case]
        pair = (fid_pair != nfid) & (nfid != -2) & covered
        front = (zbuf < nz) if strict else (zbuf <= nz)
        active = pair & front

        # Crossing-edge selection on the own (front) face's edges.
        chosen = jnp.zeros((height, width), jnp.bool_)
        for j in range(3):
            a_j, b_j, e_j = a_e[j], b_e[j], e_own[j]
            # Edge function at the back pixel center (one pixel away).
            e_back = e_j + offset * (a_j if horizontal else b_j)
            crossing = (e_j >= 0.0) & (e_back < 0.0) & ~chosen
            chosen = chosen | crossing

            denom = jnp.abs(a_j) + jnp.abs(b_j)
            if horizontal:
                guard = jnp.abs(a_j) >= A_EPS
                safe = jnp.where(guard, a_j, 1.0)
                # Crossing x in anchored coordinates: x* - ax = dx - e/a.
                coord = dxg - e_j / safe
                lo = jnp.minimum(dxg, dxg + offset)
                hi = jnp.maximum(dxg, dxg + offset)
                xs = jnp.clip(coord, lo, hi)
                vec = (xs, dyg)
            else:
                guard = jnp.abs(b_j) >= A_EPS
                safe = jnp.where(guard, b_j, 1.0)
                coord = dyg - e_j / safe
                lo = jnp.minimum(dyg, dyg + offset)
                hi = jnp.maximum(dyg, dyg + offset)
                ys = jnp.clip(coord, lo, hi)
                vec = (dxg, ys)

            scale = jnp.where(
                active & crossing & guard & (denom >= A_EPS),
                s_val / jnp.maximum(denom, A_EPS),
                0.0,
            )
            acc_edge[j][0] = acc_edge[j][0] + scale * vec[0]
            acc_edge[j][1] = acc_edge[j][1] + scale * vec[1]
            acc_edge[j][2] = acc_edge[j][2] + scale

    for j in range(3):
        for k in range(3):
            d_geo[GEO_EDGE + 3 * j + k] = acc_edge[j][k]

    return d_geo, d_att


def anchor_cotangents(geo, att, d_geo, d_att):
    """Fill the (ax, ay) columns of per-face d_geo from the plane slopes.

    Every plane depends on the anchor only through
    ``c_global = c0 - a*ax - b*ay``, so d_ax = -sum_p a_p * d_c0_p (resp. b
    for ay) over all planes p of the face.

    Implemented with rolls + column masks instead of per-column strided
    slices of the [F, 24] / [F, 3C] arrays.
    """
    channels3 = att.shape[1]
    plane_a_cols = [GEO_EDGE, GEO_EDGE + 3, GEO_EDGE + 6, GEO_Z, GEO_DEN]
    mask_a = jnp.zeros((GEO_WIDTH,), jnp.float32)
    mask_b = jnp.zeros((GEO_WIDTH,), jnp.float32)
    for a_col in plane_a_cols:
        mask_a = mask_a.at[a_col].set(1.0)
        mask_b = mask_b.at[a_col + 1].set(1.0)
    # roll(-2) puts each plane's d_c0 at its a column; roll(-1) at b.
    dg_m2 = jnp.roll(d_geo, -2, axis=1)
    dg_m1 = jnp.roll(d_geo, -1, axis=1)
    d_ax = -jnp.sum(geo * dg_m2 * mask_a[None, :], axis=1)
    d_ay = -jnp.sum(geo * dg_m1 * mask_b[None, :], axis=1)

    amask_a = jnp.zeros((channels3,), jnp.float32)
    amask_b = jnp.zeros((channels3,), jnp.float32)
    for k in range(0, channels3, 3):
        amask_a = amask_a.at[k].set(1.0)
        amask_b = amask_b.at[k + 1].set(1.0)
    da_m2 = jnp.roll(d_att, -2, axis=1)
    da_m1 = jnp.roll(d_att, -1, axis=1)
    d_ax = d_ax - jnp.sum(att * da_m2 * amask_a[None, :], axis=1)
    d_ay = d_ay - jnp.sum(att * da_m1 * amask_b[None, :], axis=1)

    keep = jnp.ones((GEO_WIDTH,), jnp.float32).at[GEO_AX].set(0.0)
    keep = keep.at[GEO_AY].set(0.0)
    e_ax = jnp.zeros((GEO_WIDTH,), jnp.float32).at[GEO_AX].set(1.0)
    e_ay = jnp.zeros((GEO_WIDTH,), jnp.float32).at[GEO_AY].set(1.0)
    return (
        d_geo * keep[None, :]
        + d_ax[:, None] * e_ax[None, :]
        + d_ay[:, None] * e_ay[None, :]
    )


def backward_jax(geo, att, fid, zbuf, pixels, grad_pixels, own_mask=None):
    """Gradients w.r.t. plane coefficients (vectorized pure-JAX engine).

    Args:
        geo: [F, 24] anchored plane data from ``setup_planes``.
        att: [F, 3*C].
        fid: [H, W] int32 face-id map (-1 background) from the forward.
        zbuf: [H, W] f32 (BIG_Z at background).
        pixels: [H, W, C] forward output.
        grad_pixels: [H, W, C] upstream cotangent.
        own_mask: optional [H, W] bool — pixels this shard OWNS. Non-owned
            (halo) rows supply neighbor-side data for boundary pairs but
            never act as the front/interior pixel, so each cross-shard pair
            is counted by exactly one device (front-pixel ownership).
    Returns:
        (d_geo [F, 24], d_att [F, 3*C], d_background [H, W, C]).
    """
    geo = jnp.asarray(geo, jnp.float32)
    att = jnp.asarray(att, jnp.float32)
    cot, covered = face_cotangent_columns(
        geo, fid, zbuf, pixels, grad_pixels, own_mask
    )
    rows = face_rows(cot, fid, covered, geo.shape[0])
    d_geo, d_att = assemble_face_gradients(geo, att, rows)
    d_background = jnp.where(covered[..., None], 0.0, grad_pixels)
    return d_geo, d_att, d_background


def face_cotangent_columns(geo, fid, zbuf, pixels, grad_pixels,
                           own_mask=None):
    """Per-pixel cotangents of the owning face's plane coefficients.

    Returns (cot [12 + 3C, H, W], covered [H, W]): the columns that reach
    the faces — 9 edge (a, b, c0), 3 denominator, then 3C attribute
    numerators — zero wherever ``covered`` is False. The anchor and z
    columns are zero per pixel (anchors are derived per face by
    :func:`assemble_face_gradients`; z gets no gradient).
    """
    covered = fid >= 0
    if own_mask is not None:
        covered = covered & own_mask
    # Gather rows once, then one transpose to channels-first; per-plane
    # slices of the [24, H, W] layout are free.
    g16cf = jnp.transpose(geo[jnp.maximum(fid, 0)], (2, 0, 1))
    pixels_cf = jnp.transpose(pixels, (2, 0, 1))      # [C, H, W]
    grad_cf = jnp.transpose(grad_pixels, (2, 0, 1))
    d_geo_cols, d_att_cols = pixel_cotangents(
        g16cf, covered, fid, zbuf, pixels_cf, grad_cf
    )
    return stack_face_columns(d_geo_cols, d_att_cols, covered), covered


def stack_face_columns(d_geo_cols, d_att_cols, covered):
    """[12 + 3C, H, W] face-reaching columns of ``pixel_cotangents_core``
    output, zero off ``covered``."""
    cols = (
        [d_geo_cols[GEO_EDGE + k] for k in range(9)]
        + [d_geo_cols[GEO_DEN + k] for k in range(3)]
        + d_att_cols
    )
    return jnp.where(covered[None], jnp.stack(cols), 0.0)


def face_rows(cot, fid, covered, num_faces: int):
    """[F, K] sums of each face's per-pixel cotangent columns.

    One ``segment_sum`` (atomic adds on the GPU). Uncovered pixels get an
    out-of-range segment id, so they are dropped instead of all adding
    zeros into one face's row.
    """
    k_cols = cot.shape[0]
    seg = jnp.where(covered, fid, num_faces).reshape(-1)
    return jax.ops.segment_sum(
        cot.reshape(k_cols, -1).T, seg, num_segments=num_faces
    )


def unpack_face_rows(rows):
    """[F, 12 + 3C] face rows -> (d_geo [F, 24] without anchors, d_att)."""
    zeros = lambda n: jnp.zeros((rows.shape[0], n), jnp.float32)
    d_geo = jnp.concatenate([
        zeros(GEO_EDGE), rows[:, 0:9], zeros(GEO_DEN - GEO_Z),
        rows[:, 9:12], zeros(GEO_WIDTH - GEO_DEN - 3),
    ], axis=1)
    return d_geo, rows[:, 12:]


def assemble_face_gradients(geo, att, rows):
    """Face rows -> (d_geo [F, 24], d_att [F, 3C]), anchors included."""
    d_geo, d_att = unpack_face_rows(rows)
    return anchor_cotangents(geo, att, d_geo, d_att), d_att
