"""Public rasterization API, mirroring the reference's ``dirt/rasterise_ops.py``
(reconstructed — SURVEY.md section 2.2).

``rasterise`` renders one mesh; ``rasterise_batch`` maps over a leading batch
dimension. Vertices are OpenGL-style clip-space homogeneous coordinates
``[V, 4]``; ``vertex_colors`` may carry any number of channels (colors, UVs,
normals, masks — anything barycentrically interpolable); ``faces`` is a
shared ``[F, 3]`` int32 triangle list.

Unlike the reference there is no op library to load: the op is a
``jax.custom_vjp`` around a Pallas kernel and composes with ``jit``,
``grad`` and ``shard_map``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dirt_tpu.ops.clipping import clip_compact_screen, inside_counts
from dirt_tpu.ops.raster import (
    STREAMING_FACES,
    RasterConfig,
    rasterize_screen,
    suggest_config,
)
from dirt_tpu.ops.triangle_setup import screen_from_clip


def _auto_clip_cap(num_faces: int) -> int:
    """Default secondary-slot budget: 1/32 of the mesh, at least 64.

    Faces crossing the near plane are a silhouette curve through the
    mesh (O(sqrt F) in practice), not an area, so 1/32 is generous for
    real scenes. The budget is deliberately small because every
    secondary slot taxes the whole pipeline (setup, binning, backward)
    even when degenerate. Overflow (more crossing faces than slots) is always flagged on the
    API, and ``suggest_raster_config`` measures the exact requirement.
    """
    return min(max(num_faces // 32, 64), num_faces)


def _face_incidence(faces_np, num_verts: int):
    """[V, max_deg] flat corner indices (f * 3 + k) per vertex, padded
    with the sentinel F * 3 (a zero row in the padded cotangent table).

    Built on the host from CONCRETE faces: the autodiff transpose of the
    per-face vertex gather ``verts[faces]`` is an XLA scatter-add; with
    the incidence table it becomes a row gather + small sum. Whether that
    still pays against the GPU's atomic scatter-add is not measured.
    Traced faces fall back to plain gather.
    """
    import numpy as np

    flat = faces_np.reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_v = flat[order]
    counts = np.bincount(sorted_v, minlength=num_verts)
    max_deg = int(counts.max()) if counts.size else 1
    inc = np.full((num_verts, max_deg), faces_np.size, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(flat.size) - starts[sorted_v]
    inc[sorted_v, rank] = order
    return jnp.asarray(inc)


@jax.custom_vjp
def _gather_by_faces(vals, faces, inc):
    """``vals[faces]`` whose vjp reduces via the incidence table.

    ``faces``/``inc`` are int arrays (zero cotangent); they ride as
    ordinary primal args so this works under jit (a closure over traced
    values would leak tracers into the backward trace).
    """
    return vals[faces]


def _gather_fwd(vals, faces, inc):
    return vals[faces], inc


def _gather_bwd(inc, ct):
    k = ct.shape[-1]
    flat = jnp.concatenate(
        [ct.reshape(-1, k), jnp.zeros((1, k), ct.dtype)]
    )
    rows = flat[inc.reshape(-1)]
    return (
        rows.reshape(inc.shape[0], inc.shape[1], k).sum(axis=1),
        None, None,
    )


_gather_by_faces.defvjp(_gather_fwd, _gather_bwd)


def _resolve_shape(background, height, width, channels):
    if background is not None:
        h, w, c = background.shape[-3], background.shape[-2], background.shape[-1]
        return h, w, c
    if height is None or width is None or channels is None:
        raise ValueError(
            "height, width and channels must be given when background is None"
        )
    return height, width, channels


def _clip_space_faces(vertices, vertex_colors, faces, height, width,
                      config, clip, inc=None):
    """Gather per-face data and (optionally) near-plane clip it.

    Clipping produces [2F] sub-triangles (``ops/clipping.py``) which are
    immediately compacted to ``F + clip_cap`` slots
    (``clipping.compact_clipped``): primaries stay at their face's slot,
    live secondaries (faces actually crossing the near plane — rare)
    compact into the trailing slots. The engine auto-switches and
    ``fid`` remapping resolve from the ORIGINAL face count.

    Returns (face_verts, face_attrs, config, orig_id, clip_overflow) —
    ``orig_id`` maps raster slot -> original face id (identity when
    ``clip=False``), ``clip_overflow`` flags dropped secondaries.
    """
    num_faces = faces.shape[0]
    if inc is not None:
        gather = lambda v: _gather_by_faces(v, faces, inc)
    else:
        gather = lambda v: v[faces]
    if clip:
        fv_clip = gather(vertices)                    # [F, 3, 4]
        fa = gather(vertex_colors)                    # [F, 3, C]
        cap = config.clip_cap
        if cap is None:
            cap = _auto_clip_cap(num_faces)
        cap = min(cap, num_faces)
        face_verts, fa_c, orig_id, clip_ovf = clip_compact_screen(
            fv_clip, fa, cap, height, width
        )
        if config.streaming is None:
            config = config._replace(
                streaming=num_faces > STREAMING_FACES
            )
        return face_verts, fa_c, config, orig_id, clip_ovf
    verts_screen = screen_from_clip(vertices, height, width)
    orig_id = jnp.arange(num_faces, dtype=jnp.int32)
    return (
        gather(verts_screen), gather(vertex_colors), config, orig_id,
        jnp.asarray(False),
    )


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _rasterise_core(background, vertices, vertex_colors, faces, h, w,
                    config, clip, inc=None):
    """Jitted device-side body shared by the public wrappers.

    The wrappers jit internally so EAGER callers (the reference's usage
    style — no surrounding ``tf.function``/``jit``) pay one cached
    whole-graph compile per (shapes, config) instead of an XLA dispatch
    + micro-compile per op. Under an outer ``jit`` the inner one is
    inlined at trace time — jitted pipelines are unaffected.
    """
    face_verts, face_attrs, config, orig_id, clip_ovf = _clip_space_faces(
        vertices, vertex_colors, faces, h, w, config, clip, inc=inc
    )
    pixels, fid, zbuf, overflow = rasterize_screen(
        face_verts, face_attrs, background, config
    )
    if clip:
        # Clipped sub-triangles live at compacted slots; report the
        # ORIGINAL face id like the reference would.
        fid = jnp.where(fid >= 0, orig_id[jnp.maximum(fid, 0)], fid)
    return pixels, fid, zbuf, overflow | clip_ovf


def _maybe_incidence(faces, num_verts):
    """Incidence table for concrete faces; None under tracing."""
    if isinstance(faces, jax.core.Tracer):
        return None
    import numpy as np

    return _face_incidence(np.asarray(faces), num_verts)


def rasterise(
    background, vertices, vertex_colors, faces,
    height=None, width=None, channels=None, config: RasterConfig | None = None,
    clip: bool = True,
):
    """Rasterize one triangle mesh with z-buffering and attribute interp.

    Args:
        background: [H, W, C] image the mesh is composited over, or None
            (zeros; then height/width/channels are required).
        vertices: [V, 4] clip-space positions.
        vertex_colors: [V, C] per-vertex attributes.
        faces: [F, 3] int32.
        clip: near-plane clip faces crossing w = 0 in homogeneous space
            (GL parity — the reference's pipeline always clips). Set False
            to skip the 2x face-array expansion when geometry is known to
            be entirely in front of the camera; crossing faces are then
            culled whole.
    Returns:
        [H, W, C] rendered image (differentiable w.r.t. background,
        vertices and vertex_colors).
    """
    h, w, c = _resolve_shape(background, height, width, channels)
    if background is None:
        background = jnp.zeros((h, w, c), jnp.float32)
    config = config or RasterConfig()

    faces = jnp.asarray(faces, jnp.int32)
    vertices = jnp.asarray(vertices, jnp.float32)
    pixels, _, _, _ = _rasterise_core(
        jnp.asarray(background, jnp.float32), vertices,
        jnp.asarray(vertex_colors, jnp.float32),
        faces, h, w, config, clip,
        inc=_maybe_incidence(faces, vertices.shape[0]),
    )
    return pixels


def rasterise_with_aux(
    background, vertices, vertex_colors, faces,
    config: RasterConfig | None = None, clip: bool = True,
):
    """Like ``rasterise`` but also returns non-diff aux outputs.

    Returns:
        (pixels [H, W, C], fid [H, W] int32, zbuf [H, W] f32,
         overflow [] bool). ``overflow`` True means a static bin cap
        truncated faces and the image may be missing coverage — rebuild
        the config with :func:`suggest_raster_config` and re-render
        (GL, the reference, can never drop triangles; here the caps are
        what make shapes static for XLA).
    """
    h, w, c = background.shape
    config = config or RasterConfig()
    faces = jnp.asarray(faces, jnp.int32)
    vertices = jnp.asarray(vertices, jnp.float32)
    return _rasterise_core(
        jnp.asarray(background, jnp.float32), vertices,
        jnp.asarray(vertex_colors, jnp.float32),
        faces, h, w, config, clip,
        inc=_maybe_incidence(faces, vertices.shape[0]),
    )


def suggest_raster_config(
    vertices, faces, height: int, width: int,
    config: RasterConfig | None = None, margin: float = 1.25,
    clip: bool = True,
):
    """Count-then-allocate: a RasterConfig that cannot overflow this scene.

    Measures exact per-tile occupancy / per-face tile span for the given
    clip-space geometry (O(F) pass, host-synchronizing — call outside
    jit) and returns a concrete config with just-large-enough caps.
    ``clip`` must match the flag later passed to ``rasterise`` so the
    measured face set is the rendered one.
    """
    faces = jnp.asarray(faces, jnp.int32)
    vertices = jnp.asarray(vertices, jnp.float32)
    config = config or RasterConfig()
    num_channels_dummy = jnp.zeros((vertices.shape[0], 1), jnp.float32)
    if clip and config.clip_cap is None:
        # Measure the exact secondary-slot requirement so the clip
        # compaction cannot overflow for this geometry.
        live = int(jax.jit(
            lambda v, f: jnp.sum((inside_counts(v[f]) == 2).astype(
                jnp.int32))
        )(vertices, faces))
        cap = min(max(int(live * margin), 8), faces.shape[0])
        config = config._replace(clip_cap=cap)

    def _fv(vertices, dummy, faces):
        return _clip_space_faces(
            vertices, dummy, faces, height, width, config, clip
        )[0]

    # Replicate _clip_space_faces's static streaming pin (it only
    # mutates the config from static values).
    cfg_out = config
    if clip and config.streaming is None:
        cfg_out = config._replace(
            streaming=faces.shape[0] > STREAMING_FACES
        )
    face_verts = jax.jit(_fv)(vertices, num_channels_dummy, faces)
    return suggest_config(face_verts, height, width, cfg_out, margin)


def rasterise_batch(
    background, vertices, vertex_colors, faces,
    height=None, width=None, channels=None, config: RasterConfig | None = None,
    clip: bool = True,
):
    """Batched rasterization over leading dims of background/vertices/colors.

    ``faces`` is shared across the batch, matching the reference op. Scenes
    are rendered sequentially with ``lax.map``, which composes cleanly
    with the custom VJP; a small image leaves most of the card idle.
    """
    h, w, c = _resolve_shape(background, height, width, channels)
    vertices = jnp.asarray(vertices, jnp.float32)
    batch = vertices.shape[0]
    if background is None:
        background = jnp.zeros((batch, h, w, c), jnp.float32)
    config = config or RasterConfig()
    vertex_colors = jnp.asarray(vertex_colors, jnp.float32)
    faces = jnp.asarray(faces, jnp.int32)

    def render_one(args):
        bg, verts, colors = args
        return rasterise(bg, verts, colors, faces, config=config, clip=clip)

    return jax.lax.map(render_one, (background, vertices, vertex_colors))
