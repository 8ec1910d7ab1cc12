"""Differentiable triangle setup: screen transform and plane coefficients.

Design note (SURVEY.md section 7): the reference's GL pipeline does
per-triangle setup in fixed-function hardware. Here setup happens in pure
JAX, producing *affine plane coefficients* per face — oriented edge
functions, screen-space depth, the perspective denominator ``sum_k b_k/w_k``
and per-channel attribute numerators ``sum_k b_k attr_k / w_k`` — so the
Pallas scan-conversion kernel only ever evaluates planes over pixel blocks
(FMAs, no per-pixel divides except one reciprocal).

Numerical design: planes are stored in **anchored form**. Each face carries
its vertex-0 screen position ``(ax, ay)`` and every plane is
``P(x, y) = a * (x - ax) + b * (y - ay) + c0`` with ``c0`` the plane value
*at the anchor*. Anchor values are exact by construction (edge 1 and edge 2
pass through vertex 0, so their c0 is literally 0; edge 0's is |2*area|;
z's is z0; the denominator's is 1/w0), and the (a, b) slopes are built from
coordinate *differences* — so there is no catastrophic cancellation in f32
even at 1024^2+ resolutions, unlike the naive global form
``C = x_a y_b - x_b y_a``.

Because setup is differentiable JAX, the custom_vjp backward only needs
gradients w.r.t. these coefficients; ``jax.vjp`` of ``setup_planes`` chains
them to screen vertex positions, 1/w and attributes exactly. A plane
depends on the anchor only through ``c_global = c0 - a*ax - b*ay``, so the
anchor cotangents are ``d_ax = -sum_p a_p * d_c0_p`` (resp. ``b_p``) — the
backward computes per-plane (da, db, dc0) and derives the anchor terms.

Geometry layout of the packed ``geo`` array ([F, 24] f32):

    0, 1    ax, ay (vertex-0 screen position — the anchor)
    2:11    a_j, b_j, c0_j for oriented edges j = 0, 1, 2
            (edge j opposite vertex j; E_j >= 0 inside for valid faces)
    11:14   z plane (OpenGL rule: z_ndc linear in screen space)
    14:17   denominator plane (sum_k b_k / w_k)
    17:24   unused (padding)

Attribute numerators are packed [F, 3*C]: channel c holds (na, nb, nc0) at
3c:3c+3 with ``nc0 = attr_0c / w_0``.
"""

from __future__ import annotations

import jax.numpy as jnp

AREA_EPS = 1e-10
W_EPS = 1e-9

GEO_WIDTH = 24
# Field offsets within a geo row.
GEO_AX, GEO_AY = 0, 1
GEO_EDGE = 2          # 9 values: (a, b, c0) x 3 edges
GEO_Z = 11            # 3 values
GEO_DEN = 14          # 3 values
GEO_USED = 17         # columns 17:24 are padding; the kernels pack
                      # attribute planes right after column GEO_USED


def screen_from_clip(vertices_clip, height: int, width: int):
    """Clip space [..., 4] -> screen space (x_s, y_s, z_ndc, invw).

    ``x_s = (x_ndc + 1)/2 * W``; ``y_s = (1 - y_ndc)/2 * H`` (row 0 = top);
    pixel (i, j) center is (j + 0.5, i + 0.5). Vertices with w <= W_EPS get
    invw <= 0, which marks their faces invalid in ``setup_planes`` —
    GL-parity near-plane clipping happens upstream in clip space
    (``ops/clipping.py``, applied by the public wrappers), so faces
    reaching this screen-space transform are either fully projectable or
    culled whole.
    """
    v = jnp.asarray(vertices_clip)
    w = v[..., 3]
    safe_w = jnp.where(jnp.abs(w) > W_EPS, w, 1.0)
    invw = jnp.where(jnp.abs(w) > W_EPS, 1.0 / safe_w, 0.0)
    x_ndc = v[..., 0] * invw
    y_ndc = v[..., 1] * invw
    z_ndc = v[..., 2] * invw
    x_s = (x_ndc + 1.0) * 0.5 * width
    y_s = (1.0 - y_ndc) * 0.5 * height
    return jnp.stack([x_s, y_s, z_ndc, invw], axis=-1)


def setup_planes(face_verts_screen, face_attrs):
    """Per-face anchored plane coefficients for the raster kernels.

    Args:
        face_verts_screen: [F, 3, 4] (x_s, y_s, z_ndc, invw).
        face_attrs: [F, 3, C].
    Returns:
        geo [F, 24] f32, att [F, 3*C] f32, valid [F] bool.
    Fully differentiable w.r.t. both array inputs (orientation and validity
    are piecewise constant, as in the reference's semantics).
    """
    fv = jnp.asarray(face_verts_screen, jnp.float32)
    fa = jnp.asarray(face_attrs, jnp.float32)
    num_faces = fv.shape[0]
    channels = fa.shape[-1]

    # Channels-first internals: [F, 3]-shaped corner arrays would make
    # every per-corner read (and its VJP) a strided minor-dim access. ONE
    # [F, 12] -> [12, F] transpose up front (whose pullback is one
    # transpose back) turns every subsequent value into a contiguous [F]
    # row vector.
    cols = fv.reshape(num_faces, 12).T                      # [12, F]
    x0, y0, z0, w0 = cols[0], cols[1], cols[2], cols[3]
    x1, y1, z1, w1 = cols[4], cols[5], cols[6], cols[7]
    x2, y2, z2, w2 = cols[8], cols[9], cols[10], cols[11]
    xs, ys, zs, ws = (x0, x1, x2), (y0, y1, y2), (z0, z1, z2), (w0, w1, w2)

    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    orient = jnp.where(area2 >= 0.0, 1.0, -1.0)
    valid = (jnp.abs(area2) > AREA_EPS) & (w0 > 0.0) & (w1 > 0.0) \
        & (w2 > 0.0)
    zero = jnp.zeros((num_faces,), jnp.float32)

    # Edge j from vertex (j+1)%3 to (j+2)%3 (opposite vertex j); invalid
    # faces get edges that exclude every pixel.
    a_e = [
        jnp.where(valid, orient * (ys[(j + 1) % 3] - ys[(j + 2) % 3]), 0.0)
        for j in range(3)
    ]
    b_e = [
        jnp.where(valid, orient * (xs[(j + 2) % 3] - xs[(j + 1) % 3]), 0.0)
        for j in range(3)
    ]
    abs_area = orient * area2  # == |area2|, differentiable through area2
    # Edge values at the anchor (vertex 0): edge 0 evaluates to 2*|area|,
    # edges 1 and 2 pass through vertex 0 (exactly zero).
    c_e = [
        jnp.where(valid, abs_area, -1.0),
        jnp.where(valid, 0.0, -1.0),
        jnp.where(valid, 0.0, -1.0),
    ]

    inv_area = jnp.where(valid, 1.0 / jnp.where(valid, abs_area, 1.0), 0.0)

    # Barycentric slope planes b_k = E_k / |area2|; affine combinations
    # give the z / denominator / numerator slopes. Anchor values come
    # directly from vertex 0 (exact), not from the combination.
    def combine_slopes(w3):  # 3-tuple of [F] -> (a, b) of combined plane
        wa = (w3[0] * a_e[0] + w3[1] * a_e[1] + w3[2] * a_e[2]) * inv_area
        wb = (w3[0] * b_e[0] + w3[1] * b_e[1] + w3[2] * b_e[2]) * inv_area
        return wa, wb

    za, zb = combine_slopes(zs)
    zc = jnp.where(valid, z0, 0.0)
    da, db = combine_slopes(ws)
    dc = jnp.where(valid, w0, 1.0)

    # Assemble both tables with ONE stack each: per-column .at[...].set
    # writes (especially strided ones) transpose into strided slice reads
    # in the VJP; a single stack's VJP is a single unstack of contiguous
    # slices.
    geo_cols = [
        jnp.where(valid, x0, 0.0),            # GEO_AX
        jnp.where(valid, y0, 0.0),            # GEO_AY
        a_e[0], b_e[0], c_e[0],               # edge 0
        a_e[1], b_e[1], c_e[1],               # edge 1
        a_e[2], b_e[2], c_e[2],               # edge 2
        za, zb, zc,                           # GEO_Z
        da, db, dc,                           # GEO_DEN
    ]
    geo = jnp.stack(geo_cols + [zero] * (GEO_WIDTH - GEO_USED), axis=1)

    # Attribute planes, same channels-first treatment: corner k of channel
    # c sits at row k*C + c of the transposed [3C, F] view.
    faT = fa.reshape(num_faces, 3 * channels).T             # [3C, F]
    att_cols = []
    for c in range(channels):
        wgt = [faT[k * channels + c] * ws[k] for k in range(3)]
        na = (wgt[0] * a_e[0] + wgt[1] * a_e[1] + wgt[2] * a_e[2]) \
            * inv_area
        nb = (wgt[0] * b_e[0] + wgt[1] * b_e[1] + wgt[2] * b_e[2]) \
            * inv_area
        nc = jnp.where(valid, wgt[0], 0.0)
        att_cols += [na, nb, nc]
    att = jnp.stack(att_cols, axis=1)                       # [F, 3C]

    return geo, att, valid


def edge_filter_cols(face_verts_screen):
    """(x0, y0, a0, b0, a1, b1, a2, b2, c0) [F] columns for binning.

    The same anchored edge planes :func:`setup_planes` packs into ``geo``
    (kernels evaluate ``e_k = a_k (x - x0) + b_k (y - y0) + c_k``,
    inside = all e_k >= 0), exposed as plain columns so
    ``binning.bin_faces_packed`` can run its exact conservative
    triangle-vs-subtile overlap filter without strided reads of the
    packed [F, 24] table. c1 = c2 = 0 for valid faces (edges 1 and 2
    pass through the anchor), so only c0 is returned; invalid faces get
    all-exclude edges. Recomputed rather than unpacked — XLA CSEs the
    shared subexpressions with setup_planes inside one jit graph.
    """
    fv = jnp.asarray(face_verts_screen, jnp.float32)
    num_faces = fv.shape[0]
    cols = fv.reshape(num_faces, 12).T
    x0, y0, w0 = cols[0], cols[1], cols[3]
    x1, y1, w1 = cols[4], cols[5], cols[7]
    x2, y2, w2 = cols[8], cols[9], cols[11]
    xs, ys = (x0, x1, x2), (y0, y1, y2)
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    orient = jnp.where(area2 >= 0.0, 1.0, -1.0)
    valid = (jnp.abs(area2) > AREA_EPS) & (w0 > 0.0) & (w1 > 0.0) \
        & (w2 > 0.0)
    a_e = [
        jnp.where(valid, orient * (ys[(j + 1) % 3] - ys[(j + 2) % 3]), 0.0)
        for j in range(3)
    ]
    b_e = [
        jnp.where(valid, orient * (xs[(j + 2) % 3] - xs[(j + 1) % 3]), 0.0)
        for j in range(3)
    ]
    c0 = jnp.where(valid, orient * area2, -1.0)
    return (x0, y0, a_e[0], b_e[0], a_e[1], b_e[1], a_e[2], b_e[2], c0)


def face_bbox_cols(face_verts_screen, valid, height: int, width: int):
    """Conservative pixel-index bounding boxes for binning (non-diff).

    Returns FOUR separate [F] int32 arrays (xmin, xmax, ymin, ymax),
    inclusive pixel indices; empty boxes are encoded with max < min.
    Faces entirely outside z in [-1, 1] are also culled here. Kept as
    separate columns on purpose: a stacked [F, 4] array forces every
    consumer's ``bbox[:, k]`` through a strided column read.
    """
    fv = jnp.asarray(face_verts_screen, jnp.float32)
    x, y, z = fv[..., 0], fv[..., 1], fv[..., 2]

    xmin = jnp.floor(jnp.min(x, axis=1) - 0.5).astype(jnp.int32)
    xmax = jnp.ceil(jnp.max(x, axis=1) - 0.5).astype(jnp.int32)
    ymin = jnp.floor(jnp.min(y, axis=1) - 0.5).astype(jnp.int32)
    ymax = jnp.ceil(jnp.max(y, axis=1) - 0.5).astype(jnp.int32)

    onscreen = (
        (xmax >= 0) & (xmin <= width - 1) & (ymax >= 0) & (ymin <= height - 1)
        & (jnp.min(z, axis=1) <= 1.0) & (jnp.max(z, axis=1) >= -1.0)
    )
    keep = valid & onscreen

    xmin = jnp.where(keep, jnp.clip(xmin, 0, width - 1), 0)
    xmax = jnp.where(keep, jnp.clip(xmax, 0, width - 1), -1)
    ymin = jnp.where(keep, jnp.clip(ymin, 0, height - 1), 0)
    ymax = jnp.where(keep, jnp.clip(ymax, 0, height - 1), -1)
    return xmin, xmax, ymin, ymax


def face_bboxes(face_verts_screen, valid, height: int, width: int):
    """[F, 4] stacked variant of :func:`face_bbox_cols` (tests/tooling)."""
    return jnp.stack(
        face_bbox_cols(face_verts_screen, valid, height, width), axis=-1
    )
