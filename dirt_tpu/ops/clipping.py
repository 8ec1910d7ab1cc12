"""Homogeneous near-plane clipping (GL parity, differentiable, static shapes).

The reference's GL pipeline clips every primitive against the near plane in
homogeneous clip space before the perspective divide (``csrc/rasterise_egl.cpp``
— "GL does clipping, perspective divide"; SURVEY.md section 2.1). Round 1
culled any face with a vertex at w <= eps, diverging from GL for geometry
crossing the camera plane. This module closes that gap with a fully
vectorized, shape-static clip pass.

Geometry: a triangle is clipped against the NEAR-PLANE half-space
``z + w > W_CLIP_EPS`` (GL's ``z_ndc >= -1`` plane in homogeneous form).
Clipping against ``w = eps`` instead would be numerically catastrophic:
seam vertices would project to screen coordinates and z_ndc of order
``1/eps``, wiping out all f32 precision in the downstream plane setup
(measured: ~30% coverage divergence from the oracle). On ``z + w = eps``
the seam sits at ``z_ndc ~= -1`` with moderate ``w`` — exactly where GL's
fixed-function clipper puts it. Vertices with ``w <= 0`` that survive the
near-plane test (possible only for faces simultaneously crossing the far
plane region, which full GL would also clip) leave their sub-triangle with
an invalid projection; ``screen_from_clip``/``setup_planes`` then cull
that sub-triangle whole — the one documented divergence from full 6-plane
clipping.

With k vertices inside the near half-space the result is:

    k = 3 -> the original triangle
    k = 2 -> a quad -> two triangles
    k = 1 -> one smaller triangle
    k = 0 -> nothing

so each input face maps to **at most two** output triangles. The output is
laid out ``[2F, 3, 4]``: slot ``i`` holds the primary triangle of face ``i``
(or a degenerate marker) and slot ``F + i`` the secondary one (non-degenerate
only in the k = 2 case). Degenerate slots have zero area and are culled for
free by ``setup_planes`` / ``face_bboxes`` — they never reach the kernels.
Face ids thus satisfy ``original_id = id % F`` (used by the public wrappers
to re-map aux fid maps).

New vertices are linear interpolations **in clip space** — positions and
attributes share the same parameter ``t = (eps - w_a) / (w_b - w_a)`` along
each crossing edge, exactly what fixed-function GL computes. Everything is
plain differentiable jnp (cheap relative to rasterization; no kernel
needed), so gradients flow to the original vertices *through the clip
point*, including through ``t``'s dependence on the w coordinates.

Numerical care: every branch is computed for every face with guarded
denominators and then selected with ``jnp.where`` — discarded branches must
stay finite or their NaNs would poison the VJP of the selects.

Winding: sub-triangles use cyclic rotations of the input order plus
seam points inserted along the walked edges, so orientation (and therefore
the oriented-edge inside test downstream) is preserved.

Layout: all internal math runs channels-first ([F]-row slabs peeled off
one [F, 3, K] -> [3, K, F] transpose). The canonical rotation is three
static cyclic selects and the compaction a top_k, so the whole pass is
plain vector math with no gathers except one row-gather of the ``cap``
compacted secondaries.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Vertices with z + w above this are "inside" the near half-space. Small
# enough to be visually identical to GL's z + w = 0 clip, but large enough
# that seam vertices land measurably ABOVE z_ndc = -1 (z_ndc ~= -1 + eps/w),
# keeping the per-pixel z-range test away from its razor edge in f32.
W_CLIP_EPS = 1e-4


def _lerp_to_plane_cf(va, vb, aa, ab, w_eps):
    """Clip-space intersection of segment a->b with the z + w = eps plane.

    Channels-first: positions [4, F], attributes [C, F].
    """
    sa = va[2] + va[3]
    sb = vb[2] + vb[3]
    den = sb - sa
    safe = jnp.where(jnp.abs(den) > 1e-20, den, 1.0)
    t = jnp.clip((w_eps - sa) / safe, 0.0, 1.0)[None]      # [1, F]
    return va + t * (vb - va), aa + t * (ab - aa)


def _clip_faces_cf(v, a, w_eps):
    """Core clip pass on channels-first slabs.

    Args:
        v: [3, 4, F] positions (corner-major).
        a: [3, C, F] attributes.
    Returns:
        (tri1_v [3, 4, F], tri1_a, tri2_v, tri2_a, n_in [F] int32).
    """
    channels = a.shape[1]
    num_faces = v.shape[2]

    s = v[:, 2] + v[:, 3]                                  # [3, F]
    inside = s > w_eps
    n_in = jnp.sum(inside.astype(jnp.int32), axis=0)       # [F]

    # Canonical rotation r: bring the distinguished vertex to corner 0 —
    # the single inside vertex (k=1) or the single outside vertex (k=2).
    # Instead of a per-face gather, each rotated corner is a 3-way select
    # among the static cyclic shifts.
    i0, i1, i2 = inside[0], inside[1], inside[2]
    r1 = jnp.where(i0, 0, jnp.where(i1, 1, 2))
    r2 = jnp.where(~i0, 0, jnp.where(~i1, 1, 2))
    r = jnp.where(n_in == 1, r1, jnp.where(n_in == 2, r2, 0))

    def rot(arr, j):
        # arr [3, K, F] -> rotated corner j = arr[(j + r) % 3]
        return jnp.where(
            r == 0, arr[j],
            jnp.where(r == 1, arr[(j + 1) % 3], arr[(j + 2) % 3]),
        )

    va, vb, vc = rot(v, 0), rot(v, 1), rot(v, 2)           # [4, F]
    aa, ab, ac = rot(a, 0), rot(a, 1), rot(a, 2)           # [C, F]

    # Seam points on the two edges leaving corner 0.
    p_ab, q_ab = _lerp_to_plane_cf(va, vb, aa, ab, w_eps)
    p_ca, q_ca = _lerp_to_plane_cf(vc, va, ac, aa, w_eps)

    # k = 1 (A inside): (A, AB*, CA*). Replacing B and C with points on
    # AB / CA keeps the cyclic order, hence the winding.
    tri1_k1_v = jnp.stack([va, p_ab, p_ca])                # [3, 4, F]
    tri1_k1_a = jnp.stack([aa, q_ab, q_ca])
    # k = 2 (A outside): quad (AB*, B, C, CA*) -> (AB*, B, C) + (AB*, C, CA*).
    tri1_k2_v = jnp.stack([p_ab, vb, vc])
    tri1_k2_a = jnp.stack([q_ab, ab, ac])
    tri2_k2_v = jnp.stack([p_ab, vc, p_ca])
    tri2_k2_a = jnp.stack([q_ab, ac, q_ca])

    # Degenerate filler: a single point at w=1 (zero area -> culled free).
    degen_v = jnp.zeros((3, 4, num_faces), jnp.float32)
    degen_v = degen_v.at[:, 3].set(1.0)
    degen_a = jnp.zeros((3, channels, num_faces), jnp.float32)

    sel = n_in[None, None]
    tri1_v = jnp.where(
        sel == 3, v,
        jnp.where(sel == 2, tri1_k2_v,
                  jnp.where(sel == 1, tri1_k1_v, degen_v)),
    )
    tri1_a = jnp.where(
        sel == 3, a,
        jnp.where(sel == 2, tri1_k2_a,
                  jnp.where(sel == 1, tri1_k1_a, degen_a)),
    )
    tri2_v = jnp.where(sel == 2, tri2_k2_v, degen_v)
    tri2_a = jnp.where(sel == 2, tri2_k2_a, degen_a)
    return tri1_v, tri1_a, tri2_v, tri2_a, n_in


def clip_faces(face_verts_clip, face_attrs, w_eps: float = W_CLIP_EPS):
    """Clip faces against the near hyperplane w = ``w_eps``.

    Args:
        face_verts_clip: [F, 3, 4] f32 homogeneous clip-space positions.
        face_attrs: [F, 3, C] f32 per-corner attributes.
    Returns:
        (verts [2F, 3, 4], attrs [2F, 3, C]) — differentiable; degenerate
        slots are zero-area triangles at w = 1.
    """
    v = jnp.transpose(jnp.asarray(face_verts_clip, jnp.float32), (1, 2, 0))
    a = jnp.transpose(jnp.asarray(face_attrs, jnp.float32), (1, 2, 0))
    tri1_v, tri1_a, tri2_v, tri2_a, _ = _clip_faces_cf(v, a, w_eps)
    return (
        jnp.transpose(jnp.concatenate([tri1_v, tri2_v], axis=2), (2, 0, 1)),
        jnp.transpose(jnp.concatenate([tri1_a, tri2_a], axis=2), (2, 0, 1)),
    )


def inside_counts(face_verts_clip, w_eps: float = W_CLIP_EPS):
    """Per-face count of vertices inside the near half-space ([F] int32)."""
    v = jnp.asarray(face_verts_clip)
    inside = (v[..., 2] + v[..., 3]) > w_eps
    return jnp.sum(inside.astype(jnp.int32), axis=1)


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def _compact_rows(rows, key, cap):
    """Gather the ``cap`` rows with the largest positive keys, key-descending.

    ``key[f] = num_faces - f`` for live faces and 0 otherwise, so the
    result is the live rows in ascending face order, padded with
    arbitrary non-live rows.

    The point of the custom VJP: autodiff's transpose of this gather is a
    scatter-add. But the slot of live face f is analytically its
    prefix-sum rank among live faces, so the backward is a plain row
    GATHER of g by rank. Filler-slot cotangents are dropped — exact, because
    filler slots select non-live faces whose rows are the constant
    degenerate marker (their cotangent dies in the ``sel == 2`` select's
    VJP anyway).
    """
    _, idx = jax.lax.top_k(key, cap)
    return rows[idx.astype(jnp.int32)]


def _compact_rows_fwd(rows, key, cap):
    live = key > 0
    rank = jnp.cumsum(live.astype(jnp.int32)) - 1          # [F]
    return _compact_rows(rows, key, cap), (live, rank)


def _compact_rows_bwd(cap, res, g):
    live, rank = res
    take = jnp.clip(rank, 0, cap - 1)
    d = g[take]                                            # [F, D] row gather
    mask = (live & (rank < cap))[:, None]
    return jnp.where(mask, d, 0.0), None


_compact_rows.defvjp(_compact_rows_fwd, _compact_rows_bwd)


def compact_clipped(verts2, attrs2, n_in, cap: int):
    """Compact the [2F] clipped face array down to [F + cap] slots.

    Only faces with exactly two inside vertices (k = 2) produce a live
    secondary sub-triangle, and on typical scenes that is a thin
    silhouette of faces crossing the camera plane — paying 2x setup /
    binning / gather / backward cost for a mostly-degenerate second half
    would tax the public ``clip=True`` default. This keeps the primary slots in place (slot i stays
    face i — valid-or-degenerate) and stably compacts the k = 2
    secondaries into ``cap`` trailing slots, preserving ascending face
    order so the rasterizer's z-tie rule (lowest id wins) is unchanged.

    The selection indices derive from the integer ``n_in`` only, so
    gradients flow to the original vertices through a plain gather.

    Returns:
        (verts [F + cap, 3, 4], attrs [F + cap, 3, C],
         orig_id [F + cap] int32 — original face of each slot,
         overflow [] bool — True if > cap secondaries were live; the
         dropped ones are the highest-id crossing faces).
    """
    num_faces = n_in.shape[0]
    channels = attrs2.shape[2]
    sec_live = n_in == 2
    # Stable compaction via top_k (same trick as binning.bin_faces). Live
    # faces
    # get positive keys decreasing in face id, so top_k returns them in
    # ascending id order; filler slots (key 0) select non-live faces,
    # whose secondary slots are degenerate by construction.
    fidx = jnp.arange(num_faces, dtype=jnp.int32)
    key = jnp.where(sec_live, num_faces - fidx, 0)
    _, idx = jax.lax.top_k(key, cap)
    idx = idx.astype(jnp.int32)
    # Flat row-gather of the compacted secondary sub-triangles;
    # rank-gather backward via _compact_rows.
    sec_v = _compact_rows(verts2[num_faces:].reshape(num_faces, 12), key, cap)
    sec_a = _compact_rows(
        attrs2[num_faces:].reshape(num_faces, 3 * channels), key, cap
    )
    verts = jnp.concatenate(
        [verts2[:num_faces], sec_v.reshape(cap, 3, 4)]
    )
    attrs = jnp.concatenate(
        [attrs2[:num_faces], sec_a.reshape(cap, 3, channels)]
    )
    orig_id = jnp.concatenate([fidx, idx])
    overflow = jnp.sum(sec_live.astype(jnp.int32)) > cap
    return verts, attrs, orig_id, overflow


def clip_and_compact(face_verts_clip, face_attrs, cap: int,
                     w_eps: float = W_CLIP_EPS):
    """Fused :func:`clip_faces` + :func:`compact_clipped` production path.

    One channels-first clip pass, no intermediate [2F] array: primaries
    come back in place and the ``cap`` live secondaries are row-gathered
    directly from the secondary slab.

    Returns:
        (verts [F + cap, 3, 4], attrs [F + cap, 3, C],
         orig_id [F + cap] int32, overflow [] bool).
    """
    v = jnp.transpose(jnp.asarray(face_verts_clip, jnp.float32), (1, 2, 0))
    a = jnp.transpose(jnp.asarray(face_attrs, jnp.float32), (1, 2, 0))
    num_faces = v.shape[2]
    channels = a.shape[1]
    tri1_v, tri1_a, tri2_v, tri2_a, n_in = _clip_faces_cf(v, a, w_eps)

    sec_live = n_in == 2
    fidx = jnp.arange(num_faces, dtype=jnp.int32)
    key = jnp.where(sec_live, num_faces - fidx, 0)
    _, idx = jax.lax.top_k(key, cap)
    idx = idx.astype(jnp.int32)

    tri1_v_rm = jnp.transpose(tri1_v, (2, 0, 1))
    tri1_a_rm = jnp.transpose(tri1_a, (2, 0, 1))
    sec_v = _compact_rows(
        jnp.transpose(tri2_v, (2, 0, 1)).reshape(num_faces, 12), key, cap
    )
    sec_a = _compact_rows(
        jnp.transpose(tri2_a, (2, 0, 1)).reshape(num_faces, 3 * channels),
        key, cap,
    )
    verts = jnp.concatenate([tri1_v_rm, sec_v.reshape(cap, 3, 4)])
    attrs = jnp.concatenate([tri1_a_rm, sec_a.reshape(cap, 3, channels)])
    orig_id = jnp.concatenate([fidx, idx])
    overflow = jnp.sum(sec_live.astype(jnp.int32)) > cap
    return verts, attrs, orig_id, overflow


def _screen_cf(v, height, width, w_eps_screen):
    """Clip -> screen transform on a channels-first corner slab [4, F].

    Same semantics as ``triangle_setup.screen_from_clip`` (which see), but
    on [4, F] slabs where every coordinate is a free row slice. Running
    the public row-major version on the [F + cap, 3, 4] clipped face
    array would turn its ``v[..., k]`` reads and ``stack(..., -1)`` into
    strided minor-dim-4 accesses, in the forward and again in the VJP.
    """
    w = v[3]
    ok = jnp.abs(w) > w_eps_screen
    safe_w = jnp.where(ok, w, 1.0)
    invw = jnp.where(ok, 1.0 / safe_w, 0.0)
    x_s = (v[0] * invw + 1.0) * (0.5 * width)
    y_s = (1.0 - v[1] * invw) * (0.5 * height)
    return jnp.stack([x_s, y_s, v[2] * invw, invw])


def clip_compact_screen(face_verts_clip, face_attrs, cap: int,
                        height: int, width: int,
                        w_eps: float = W_CLIP_EPS):
    """:func:`clip_and_compact` fused with the clip->screen transform.

    The production ``clip=True`` path: one channels-first pass does the
    near-plane clip AND the perspective divide / viewport transform while
    the data is still in [3, 4, F] slab layout, so no strided minor-dim-4
    math ever materializes. Returns SCREEN-space faces
    (verts [F + cap, 3, 4] of (x_s, y_s, z_ndc, invw), attrs, orig_id,
    overflow) ready for ``rasterize_screen``.
    """
    from dirt_tpu.ops.triangle_setup import W_EPS

    v = jnp.transpose(jnp.asarray(face_verts_clip, jnp.float32), (1, 2, 0))
    a = jnp.transpose(jnp.asarray(face_attrs, jnp.float32), (1, 2, 0))
    num_faces = v.shape[2]
    channels = a.shape[1]
    tri1_v, tri1_a, tri2_v, tri2_a, n_in = _clip_faces_cf(v, a, w_eps)

    tri1_s = jnp.stack([_screen_cf(tri1_v[i], height, width, W_EPS)
                        for i in range(3)])
    tri2_s = jnp.stack([_screen_cf(tri2_v[i], height, width, W_EPS)
                        for i in range(3)])

    sec_live = n_in == 2
    fidx = jnp.arange(num_faces, dtype=jnp.int32)
    key = jnp.where(sec_live, num_faces - fidx, 0)
    _, idx = jax.lax.top_k(key, cap)
    idx = idx.astype(jnp.int32)

    tri1_v_rm = jnp.transpose(tri1_s, (2, 0, 1))
    tri1_a_rm = jnp.transpose(tri1_a, (2, 0, 1))
    sec_v = _compact_rows(
        jnp.transpose(tri2_s, (2, 0, 1)).reshape(num_faces, 12), key, cap
    )
    sec_a = _compact_rows(
        jnp.transpose(tri2_a, (2, 0, 1)).reshape(num_faces, 3 * channels),
        key, cap,
    )
    verts = jnp.concatenate([tri1_v_rm, sec_v.reshape(cap, 3, 4)])
    attrs = jnp.concatenate([tri1_a_rm, sec_a.reshape(cap, 3, channels)])
    orig_id = jnp.concatenate([fidx, idx])
    overflow = jnp.sum(sec_live.astype(jnp.int32)) > cap
    return verts, attrs, orig_id, overflow


def needs_clipping(face_verts_clip, w_eps: float = W_CLIP_EPS):
    """[] bool — True if any face actually crosses the near plane.

    Traced value; useful for eager-mode checks / tests, not for static
    branching under jit.
    """
    v = jnp.asarray(face_verts_clip)
    s_in = (v[..., 2] + v[..., 3]) > w_eps
    any_in = jnp.any(s_in, axis=1)
    all_in = jnp.all(s_in, axis=1)
    return jnp.any(any_in & ~all_in)
