"""Slow, obviously-correct reference rasterizer (the correctness oracle).

This module defines the *semantics* the Pallas kernels must match (SURVEY.md
sections 4 and 7): a dense NumPy per-face-loop forward pass, an interior
gradient oracle obtained by JAX autodiff of an independent fixed-coverage
renderer, and a NumPy loop implementation of the occlusion-aware boundary
(silhouette / self-occlusion) gradient model.

Conventions (shared with the production path — tests assert exact agreement):

* Screen space: ``x_s = (x_ndc + 1) / 2 * W``, ``y_s = (1 - y_ndc) / 2 * H``
  (row 0 is the top of the image); pixel (i, j) has center
  ``(x, y) = (j + 0.5, i + 0.5)``.
* Face vertex data is *screen space*: ``[F, 3, 4]`` with components
  ``(x_s, y_s, z_ndc, 1/w_clip)``.
* Coverage: a pixel is inside a face iff all three oriented edge functions
  are >= 0 (both windings render; orientation = sign of twice the signed
  area). Degenerate faces (|2*area| <= AREA_EPS) never cover.
* Depth: z_ndc interpolated *linearly in screen space* (the OpenGL rule);
  a face wins a pixel iff ``z < zbuf`` strictly AND ``-1 <= z <= 1``;
  faces are processed in ascending index order, so on exact z ties the
  lowest face index wins. Background has ``fid = -1`` and ``zbuf = +inf``.
* Attributes: perspective-correct. With screen barycentrics ``b_k`` and
  vertex ``invw_k``: ``color = sum_k b_k invw_k attr_k / sum_k b_k invw_k``.

Boundary-gradient model (DIRT-style, occlusion-aware — assigned to the
*frontmost* face's crossing edge; SURVEY.md section 3.2):

For each horizontally / vertically adjacent pixel pair with different face
ids, the front pixel is the one with smaller zbuf. Let ``S = 0.5 * sum_c
(grad_pixels[front, c] + grad_pixels[back, c]) * (pixels[front, c] -
pixels[back, c])`` — both pixels' intensities change as the edge sweeps the
pair (each across half the sub-pixel window, hence the 1/2; a one-sided
form is blind to loss signal on the covered side). The crossing
edge of the front face is the lowest-index edge with ``E >= 0`` at the front
pixel center and ``E < 0`` at the back pixel center. Writing that edge's
oriented plane as ``E(x, y) = A x + B y + C``, the pair contributes

    d(A, B, C) += S * (x*, y*, 1) / (|A| + |B|)

where ``(x*, y*)`` is the crossing point of the edge with the segment
between the two pixel centers (clamped to it). This is the
intensity-difference x edge-motion model of OpenDR/DIRT with the horizontal
and vertical contributions blended by the edge-normal direction cosines
``|A| / (|A|+|B|)`` and ``|B| / (|A|+|B|)`` (the 1/A, 1/B crossing Jacobians
cancel the cosines, leaving the bounded form above). Gradients chain from
(A, B, C) to the two edge-endpoint vertices' screen x, y.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

AREA_EPS = 1e-10
W_EPS = 1e-9


def screen_from_clip(vertices_clip, height, width):
    """Clip-space [..., 4] -> screen-space (x_s, y_s, z_ndc, invw) (NumPy)."""
    v = np.asarray(vertices_clip, np.float64)
    w = v[..., 3]
    invw = np.where(np.abs(w) > W_EPS, 1.0 / w, 0.0)
    ndc = v[..., :3] * invw[..., None]
    x_s = (ndc[..., 0] + 1.0) * 0.5 * width
    y_s = (1.0 - ndc[..., 1]) * 0.5 * height
    return np.stack([x_s, y_s, ndc[..., 2], invw], axis=-1)


def clip_faces_np(face_verts_clip, face_attrs, w_eps=1e-4):
    # NOTE: default w_eps must equal ops.clipping.W_CLIP_EPS.
    """Near-plane clipping oracle: per-face Sutherland-Hodgman loop.

    Independent of ``ops/clipping.py`` (plain Python walk of each face's
    directed edges against the near half-space ``z + w > eps``, fan
    triangulation), but with seam points computed by the *same f32 formula*
    ``start + t * (end - start)``, ``t = (eps - s_start)/(s_end - s_start)``
    (``s = z + w``) along the same directed original edges — so seam vertex
    coordinates are bitwise equal to production and coverage comparisons
    are exact.

    Returns (verts [2F, 3, 4] f32, attrs [2F, 3, C] f32, orig_id [2F] i32)
    with degenerate zero-area padding (w = 1) in unused slots; the slot
    layout (primary tri at i, secondary at F + i) matches production so
    face ids compare directly.
    """
    v = np.asarray(face_verts_clip, np.float32)
    a = np.asarray(face_attrs, np.float32)
    num_faces, _, channels = a.shape
    eps32 = np.float32(w_eps)

    out_v = np.zeros((2 * num_faces, 3, 4), np.float32)
    out_v[..., 3] = 1.0
    out_a = np.zeros((2 * num_faces, 3, channels), np.float32)
    orig = np.concatenate([np.arange(num_faces, dtype=np.int32)] * 2)

    for f in range(num_faces):
        poly = []
        for i in range(3):
            j = (i + 1) % 3
            pi, pj = v[f, i], v[f, j]
            si = pi[2] + pi[3]
            sj = pj[2] + pj[3]
            inside_i = si > eps32
            inside_j = sj > eps32
            if inside_i:
                poly.append((pi, a[f, i]))
            if inside_i != inside_j:
                den = sj - si
                if abs(den) <= 1e-20:
                    den = np.float32(1.0)
                t = np.float32(min(max((eps32 - si) / den, 0.0), 1.0))
                poly.append(
                    (pi + t * (pj - pi), a[f, i] + t * (a[f, j] - a[f, i]))
                )
        if len(poly) < 3:
            continue
        # Fan triangulation of the (3- or 4-gon) clipped polygon.
        tris = [
            (poly[0], poly[k], poly[k + 1]) for k in range(1, len(poly) - 1)
        ]
        for slot, tri in zip((f, num_faces + f), tris):
            out_v[slot] = np.stack([c[0] for c in tri])
            out_a[slot] = np.stack([c[1] for c in tri])

    return out_v, out_a, orig


def oracle_forward_clipped(face_verts_clip, face_attrs, background,
                           height=None, width=None):
    """Clip-space oracle forward: clip -> screen transform -> rasterize.

    Returns (pixels, orig_fid, zbuf) with fid re-mapped to original face
    ids (``fid % F``), matching the public ``rasterise_with_aux`` wrapper.
    """
    bg = np.asarray(background)
    height = height if height is not None else bg.shape[0]
    width = width if width is not None else bg.shape[1]
    cv, ca, _ = clip_faces_np(face_verts_clip, face_attrs)
    fv = screen_from_clip(cv, height, width)
    pixels, fid, zbuf = oracle_forward(fv, ca, bg)
    num_faces = np.asarray(face_verts_clip).shape[0]
    fid = np.where(fid >= 0, fid % num_faces, fid).astype(np.int32)
    return pixels, fid, zbuf


def _edge_planes(face_verts_screen):
    """Oriented edge planes for each face.

    Edge k is opposite vertex k: edge 0 = v1->v2, edge 1 = v2->v0,
    edge 2 = v0->v1. Returns (A, B, C) each [F, 3], plus orient [F] and
    twice-signed-area [F]. E_k(x, y) = A x + B y + C is >= 0 inside for
    valid faces regardless of winding.
    """
    fv = np.asarray(face_verts_screen, np.float64)
    x, y = fv[..., 0], fv[..., 1]  # [F, 3]
    area2 = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (
        y[:, 1] - y[:, 0]
    ) * (x[:, 2] - x[:, 0])
    orient = np.where(area2 >= 0.0, 1.0, -1.0)
    edge_from = [1, 2, 0]
    edge_to = [2, 0, 1]
    xa, ya = x[:, edge_from], y[:, edge_from]  # [F, 3]
    xb, yb = x[:, edge_to], y[:, edge_to]
    a_coef = orient[:, None] * (ya - yb)
    b_coef = orient[:, None] * (xb - xa)
    c_coef = orient[:, None] * (xa * yb - xb * ya)
    return a_coef, b_coef, c_coef, orient, area2


def oracle_forward(face_verts_screen, face_attrs, background):
    """Dense per-face-loop rasterization.

    Args:
        face_verts_screen: [F, 3, 4] (x_s, y_s, z_ndc, invw).
        face_attrs: [F, 3, C].
        background: [H, W, C].
    Returns:
        (pixels [H, W, C] f32, fid [H, W] i32, zbuf [H, W] f32)
    """
    fv = np.asarray(face_verts_screen, np.float64)
    fa = np.asarray(face_attrs, np.float64)
    bg = np.asarray(background, np.float64)
    num_faces = fv.shape[0]
    height, width, channels = bg.shape

    a_coef, b_coef, c_coef, _, area2 = _edge_planes(fv)
    valid = np.abs(area2) > AREA_EPS
    # Screen-space contract: faces with any vertex at invw <= 0 are culled
    # whole (they have no valid projection). GL-parity near-plane CLIPPING
    # happens upstream in clip space (clip_faces_np /
    # oracle_forward_clipped), matching the production wrappers.
    valid &= np.all(fv[:, :, 3] > 0.0, axis=1)

    ys, xs = np.meshgrid(
        np.arange(height, dtype=np.float64) + 0.5,
        np.arange(width, dtype=np.float64) + 0.5,
        indexing="ij",
    )

    pixels = bg.copy()
    zbuf = np.full((height, width), np.inf)
    fid = np.full((height, width), -1, np.int32)

    for f in range(num_faces):
        if not valid[f]:
            continue
        e = (
            a_coef[f][:, None, None] * xs[None]
            + b_coef[f][:, None, None] * ys[None]
            + c_coef[f][:, None, None]
        )  # [3, H, W]
        inside = np.all(e >= 0.0, axis=0)
        if not inside.any():
            continue
        abs_area = np.abs(area2[f])
        bary = e / abs_area  # screen-space barycentrics, [3, H, W]
        z = np.einsum("k,khw->hw", fv[f, :, 2], bary)
        mask = inside & (z < zbuf) & (z >= -1.0) & (z <= 1.0)
        if not mask.any():
            continue
        invw = fv[f, :, 3]
        den = np.einsum("k,khw->hw", invw, bary)
        num = np.einsum("kc,khw->hwc", fa[f] * invw[:, None], bary)
        color = num / den[..., None]
        pixels = np.where(mask[..., None], color, pixels)
        zbuf = np.where(mask, z, zbuf)
        fid = np.where(mask, f, fid)

    return (
        pixels.astype(np.float32),
        fid.astype(np.int32),
        zbuf.astype(np.float32),
    )


def fixed_coverage_render(face_verts_screen, face_attrs, background, fid):
    """Differentiable JAX renderer at *fixed* coverage (for the interior
    gradient oracle).

    Given the face-id map from a forward pass, recompute every covered
    pixel's color from the face vertex data via per-pixel cross products
    (an algebraically independent path from the production plane setup).
    ``jax.grad`` of a loss through this function is the exact interior
    gradient (the gradient at fixed discrete coverage).
    """
    fv = jnp.asarray(face_verts_screen)
    fa = jnp.asarray(face_attrs)
    bg = jnp.asarray(background)
    height, width = bg.shape[0], bg.shape[1]

    safe_fid = jnp.maximum(fid, 0)
    v = fv[safe_fid]  # [H, W, 3, 4]
    attrs = fa[safe_fid]  # [H, W, 3, C]

    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=fv.dtype) + 0.5,
        jnp.arange(width, dtype=fv.dtype) + 0.5,
        indexing="ij",
    )
    p = jnp.stack([xs, ys], axis=-1)  # [H, W, 2]

    def edge(a, b, q):
        return (b[..., 0] - a[..., 0]) * (q[..., 1] - a[..., 1]) - (
            b[..., 1] - a[..., 1]
        ) * (q[..., 0] - a[..., 0])

    covered = (fid >= 0)[..., None]
    v0, v1, v2 = v[..., 0, :2], v[..., 1, :2], v[..., 2, :2]
    e0 = edge(v1, v2, p)
    e1 = edge(v2, v0, p)
    e2 = edge(v0, v1, p)
    # Uncovered pixels evaluate face 0 far from its triangle, where the
    # denominators may vanish; divide by 1 there so the discarded branch
    # stays finite and its zero cotangent cannot turn into 0 * inf = NaN.
    area2 = jnp.where(covered[..., 0], edge(v0, v1, v2), 1.0)
    bary = jnp.stack([e0, e1, e2], axis=-1) / area2[..., None]  # [H, W, 3]

    invw = v[..., 3]  # [H, W, 3]
    weights = bary * invw
    den = jnp.where(covered, jnp.sum(weights, axis=-1, keepdims=True), 1.0)
    color = jnp.einsum(
        "hwk,hwkc->hwc", weights, attrs, precision=jax.lax.Precision.HIGHEST
    ) / den
    return jnp.where(covered, color, bg)


def oracle_interior_grads(
    face_verts_screen, face_attrs, background, fid, grad_pixels
):
    """Interior gradients via autodiff of ``fixed_coverage_render``."""

    def loss(fv, fa, bg):
        out = fixed_coverage_render(fv, fa, bg, fid)
        return jnp.sum(out * jnp.asarray(grad_pixels))

    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(face_verts_screen, jnp.float32),
        jnp.asarray(face_attrs, jnp.float32),
        jnp.asarray(background, jnp.float32),
    )


def oracle_edge_grads(face_verts_screen, pixels, grad_pixels, fid, zbuf):
    """Boundary-term gradients w.r.t. screen vertex x, y (NumPy loops).

    Returns d_face_verts_screen [F, 3, 4] with only x, y components nonzero.
    """
    fv = np.asarray(face_verts_screen, np.float64)
    img = np.asarray(pixels, np.float64)
    g = np.asarray(grad_pixels, np.float64)
    fid = np.asarray(fid)
    zb = np.asarray(zbuf, np.float64)
    height, width = fid.shape

    a_coef, b_coef, c_coef, orient, _ = _edge_planes(fv)
    edge_from = [1, 2, 0]
    edge_to = [2, 0, 1]

    d_fv = np.zeros_like(fv)

    def accumulate(py_f, px_f, py_b, px_b, horizontal):
        """One adjacent pair: front pixel (py_f, px_f), back (py_b, px_b)."""
        f = fid[py_f, px_f]
        if f < 0:
            return
        s_val = 0.5 * np.dot(
            g[py_f, px_f] + g[py_b, px_b], img[py_f, px_f] - img[py_b, px_b]
        )
        if s_val == 0.0:
            return
        xf, yf = px_f + 0.5, py_f + 0.5
        xb, yb = px_b + 0.5, py_b + 0.5
        # Oriented edge functions of face f at both centers.
        e_front = a_coef[f] * xf + b_coef[f] * yf + c_coef[f]
        e_back = a_coef[f] * xb + b_coef[f] * yb + c_coef[f]
        crossing = (e_front >= 0.0) & (e_back < 0.0)
        if not crossing.any():
            return
        j = int(np.argmax(crossing))  # lowest crossing edge index
        aj, bj, cj = a_coef[f, j], b_coef[f, j], c_coef[f, j]
        denom = abs(aj) + abs(bj)
        if denom < 1e-12:
            return
        if horizontal:
            if abs(aj) < 1e-12:
                return
            y_c = yf  # same row
            x_star = -(bj * y_c + cj) / aj
            x_star = np.clip(x_star, min(xf, xb), max(xf, xb))
            grad_abc = s_val * np.array([x_star, y_c, 1.0]) / denom
        else:
            if abs(bj) < 1e-12:
                return
            x_c = xf  # same column
            y_star = -(aj * x_c + cj) / bj
            y_star = np.clip(y_star, min(yf, yb), max(yf, yb))
            grad_abc = s_val * np.array([x_c, y_star, 1.0]) / denom
        d_a, d_b, d_c = grad_abc
        va, vb = edge_from[j], edge_to[j]
        o = orient[f]
        x_a, y_a = fv[f, va, 0], fv[f, va, 1]
        x_b, y_b = fv[f, vb, 0], fv[f, vb, 1]
        # A = o*(y_a - y_b); B = o*(x_b - x_a); C = o*(x_a*y_b - x_b*y_a)
        d_fv[f, va, 1] += o * d_a
        d_fv[f, vb, 1] -= o * d_a
        d_fv[f, vb, 0] += o * d_b
        d_fv[f, va, 0] -= o * d_b
        d_fv[f, va, 0] += o * d_c * y_b
        d_fv[f, vb, 1] += o * d_c * x_a
        d_fv[f, vb, 0] -= o * d_c * y_a
        d_fv[f, va, 1] -= o * d_c * x_b

    for i in range(height):
        for j in range(width - 1):
            if fid[i, j] == fid[i, j + 1]:
                continue
            if zb[i, j] < zb[i, j + 1]:
                accumulate(i, j, i, j + 1, True)
            else:
                accumulate(i, j + 1, i, j, True)
    for i in range(height - 1):
        for j in range(width):
            if fid[i, j] == fid[i + 1, j]:
                continue
            if zb[i, j] < zb[i + 1, j]:
                accumulate(i, j, i + 1, j, False)
            else:
                accumulate(i + 1, j, i, j, False)

    return d_fv.astype(np.float32)


def oracle_backward(
    face_verts_screen, face_attrs, background, fid, zbuf, pixels, grad_pixels
):
    """Full oracle backward: interior (autodiff) + boundary (loops).

    Returns (d_face_verts_screen, d_face_attrs, d_background).
    """
    d_fv_int, d_fa, d_bg = oracle_interior_grads(
        face_verts_screen, face_attrs, background, fid, grad_pixels
    )
    d_fv_edge = oracle_edge_grads(
        face_verts_screen, pixels, grad_pixels, fid, zbuf
    )
    return (
        np.asarray(d_fv_int) + d_fv_edge,
        np.asarray(d_fa),
        np.asarray(d_bg),
    )
