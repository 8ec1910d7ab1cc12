"""The differentiable rasterization op: forward kernel + custom VJP.

This is the equivalent of the reference's op pair
``Rasterise`` / ``RasteriseGrad`` plus its Python gradient registration
(``dirt/rasterise_ops.py`` — ``@ops.RegisterGradient('Rasterise')``;
SURVEY.md sections 2.1, 2.2, 3.1, 3.2), collapsed into one
``jax.custom_vjp`` around pure-JAX triangle setup, binning, and the Pallas
scan-conversion kernel.

Differentiation boundary: ``rasterize_screen`` takes *screen-space* face
vertex data ``[F, 3, 4]`` (x_s, y_s, z_ndc, 1/w) and per-face vertex
attributes ``[F, 3, C]``. Everything upstream (vertex gather by faces,
clip -> screen transform, model/view/projection) is ordinary differentiable
JAX, so gradients reach object-space vertices, camera and lights through
the chain rule. Gradients returned:

* d attrs: exact (barycentric scatter).
* d vertex x_s, y_s: exact interior term + approximate occlusion-aware
  boundary term (DIRT semantics).
* d invw: exact interior (perspective-correction) term.
* d z_ndc: zero — the depth test is winner-take-all; visibility changes are
  carried by the boundary term, matching the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dirt_tpu import config as cfg
from dirt_tpu.ops import binning
from dirt_tpu.ops.raster_bwd import backward_jax
from dirt_tpu.ops.raster_fwd import (
    csr_lists,
    dense_lists,
    pack_face_table,
    packed_lists,
    raster_forward,
)
from dirt_tpu.ops.triangle_setup import (
    edge_filter_cols,
    face_bbox_cols,
    face_bboxes,
    setup_planes,
)


class RasterConfig(NamedTuple):
    """Static kernel configuration (hashable; a custom_vjp nondiff arg).

    ``engine`` picks the binning; all three feed the same scan kernel
    (``ops.raster_fwd``) and the same backward:

    * ``"packed"`` — per 8x16-subtile face lists: faces only pay for the
      subtiles their bbox overlaps; meant for meshes of small/medium
      triangles.
    * ``"dense"`` — per-tile lists from a [tiles, F] overlap matrix;
      robust for low-poly scenes with huge faces.
    * ``"csr"`` — per-tile lists from a sorted (tile, face) pair
      expansion; no [tiles, F] matrix, for large meshes.
    * ``"auto"`` — packed for >= PACKED_MIN_FACES faces, dense below;
      an explicit ``streaming`` flag still forces csr/dense.

    ``expand_cap`` caps how many tiles (csr) / subtiles (packed) a single
    face may overlap; ``budget`` is the packed engine's iteration budget.
    Auto values are overflow-flagged, never silent; ``suggest_config``
    measures exact requirements.
    """

    tile_h: int | None = None
    tile_w: int = cfg.TILE_W
    bin_cap: int | None = None
    streaming: bool | None = None
    expand_cap: int | None = None
    engine: str = "auto"
    budget: int | None = None
    # Near-plane clipping slot budget: max SECONDARY sub-triangles kept by
    # the clip compaction (``ops.clipping.compact_clipped``). None = auto
    # (max(F // 32, 64)); only faces actually crossing the near plane need
    # a slot, so the raster array is F + clip_cap instead of 2F. Overflow
    # (more crossing faces than slots) is reported via the API's overflow
    # flag; ``suggest_raster_config`` measures the exact requirement.
    clip_cap: int | None = None
    # Packed engine's flat candidate-pool size (total (face, subtile)
    # slots after POOL_ALIGN run alignment). None = auto
    # (binning.auto_pool_cap); overflow-flagged, measured exactly by
    # ``suggest_config``.
    pool_cap: int | None = None
    # Packed binning live-prefix cap: all post-sort binning stages run on
    # the first ``work_cap`` sorted candidates (dead/filtered candidates
    # sort last — see binning.bin_faces_packed). None = no slicing
    # (exact); ``suggest_config`` measures nsid + filtered jobs exactly.
    # Undersized caps truncate cleanly and raise the overflow flag.
    work_cap: int | None = None

    def concrete(self, height: int) -> "RasterConfig":
        """Resolve auto fields for a given image height.

        Taller tiles mean fewer, longer per-tile lists (less binning work)
        at high resolution; small images want more, smaller tiles so the
        dense and CSR lists stay short. The GPU's best heights are not
        measured yet.
        """
        if self.tile_h is not None:
            return self
        return self._replace(tile_h=64 if height >= 512 else cfg.TILE_H)


# Above this face count the public clip=True path pins ``streaming`` and
# with it the CSR binning, whose cost scales with face-tile pairs instead
# of the dense engine's [tiles, F] matrix.
STREAMING_FACES = 16384

# Below this, the dense whole-tile engine runs: it handles faces of ANY
# screen size with no caps (a [T, F] overlap matrix is cheap at these
# counts), whereas the packed engine's expand/budget heuristics assume
# dense-mesh statistics (many small triangles). A 700-face scene of
# near-fullscreen triangles overflowed the packed auto caps in
# verification — flagged, but the dense engine simply renders it.
PACKED_MIN_FACES = 4096


def use_streaming(config: RasterConfig, num_faces: int) -> bool:
    if config.streaming is not None:
        return config.streaming
    return num_faces > STREAMING_FACES


def resolve_engine(config: RasterConfig, num_faces: int) -> str:
    """Which raster path runs for this (config, face count).

    ``streaming=True`` forces the csr binning; ``streaming=False`` only
    rules csr out (the clip wrapper pins ``streaming`` from the pre-clip
    face count and must not disable packed).
    """
    if config.engine != "auto":
        return config.engine
    if config.streaming is True:
        return "csr"
    if num_faces >= PACKED_MIN_FACES:
        return "packed"
    return "dense"


def _pad_to(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def resolve_bin_cap(
    config: RasterConfig, num_faces: int, num_tiles: int,
    streaming: bool = False,
) -> int:
    """Per-tile face cap: explicit, or a multiple of the mean density.

    Mean binned faces per tile is about F * overlap / T; hot tiles (mesh
    silhouettes, dense regions) run several times the mean, so a margin
    keeps the ``overflow`` flag quiet on typical scenes while the static
    bins stay small. The CSR path uses a 4x margin (dense: 8x).
    Overflow is still *reported*, never silent.
    """
    if config.bin_cap is not None:
        cap = config.bin_cap
    else:
        mean = -(-2 * num_faces // max(num_tiles, 1))
        if streaming:
            cap = max(2048, 4 * mean)
        else:
            cap = max(cfg.DEFAULT_BIN_CAP, 8 * mean)
    return max(min(cap, max(num_faces, 1)), 1)


def _scan_inputs(face_verts_screen, face_attrs, background, config):
    """Setup, binning and face lists for the scan kernel.

    Returns (lists, table, bg_chw, overflow): the per-block face lists
    (``raster_fwd.FaceLists``) of the resolved engine, the packed face
    table, the tile-padded channels-first background, and the binning's
    overflow flags (per tile for the dense engine, a scalar otherwise).
    """
    height, width, channels = background.shape
    config = config.concrete(height)
    tile_h, tile_w = config.tile_h, config.tile_w
    num_faces = face_verts_screen.shape[0]
    engine = resolve_engine(config, num_faces)
    streaming = engine == "csr" or (
        engine != "packed" and use_streaming(config, num_faces)
    )
    hp, wp = _pad_to(height, tile_h), _pad_to(width, tile_w)
    tiles_y, tiles_x = hp // tile_h, wp // tile_w
    n_tiles = tiles_y * tiles_x
    cap = resolve_bin_cap(config, num_faces, n_tiles, streaming)

    with jax.named_scope("dirt_setup"):
        geo, att, valid = setup_planes(face_verts_screen, face_attrs)
        bbox = face_bbox_cols(face_verts_screen, valid, height, width)
        table = pack_face_table(geo, att)

    bg_chw = jnp.transpose(background, (2, 0, 1))
    bg_chw = jnp.pad(bg_chw, ((0, 0), (0, hp - height), (0, wp - width)))

    if engine == "packed":
        _, _, strips, groups = binning.packed_grid(hp, wp, tile_h, tile_w)
        nsid = n_tiles * strips * groups
        expand = config.expand_cap or binning.auto_packed_expand(
            num_faces, nsid
        )
        budget = config.budget or binning.auto_packed_budget(
            num_faces, hp, wp, tile_h, tile_w, expand
        )
        with jax.named_scope("dirt_binning_packed"):
            edges = jax.lax.stop_gradient(
                edge_filter_cols(face_verts_screen)
            )
            bins = binning.bin_faces_packed(
                bbox, hp, wp, tile_h, tile_w, budget, expand,
                edges=edges, pool_cap=config.pool_cap,
                work_cap=config.work_cap,
            )
            lists = packed_lists(bins, tiles_y, tiles_x, tile_h)
    elif streaming:
        expand = config.expand_cap or binning.auto_expand_cap(
            num_faces, n_tiles
        )
        cap = _pad_to(cap, binning.CHUNK)
        with jax.named_scope("dirt_binning_csr"):
            bins = binning.bin_faces_csr(
                bbox, height, width, tile_h, tile_w, cap, expand
            )
            lists = csr_lists(bins, tiles_y, tiles_x, tile_h)
    else:
        with jax.named_scope("dirt_binning"):
            bins = binning.bin_faces(
                bbox, height, width, tile_h, tile_w, cap
            )
            lists = dense_lists(bins, tiles_y, tiles_x, tile_h)
    return lists, table, bg_chw, bins.overflow


def _forward_impl(face_verts_screen, face_attrs, background, config,
                  scan=raster_forward):
    """Forward pass; ``scan`` is the kernel or its plain-XLA twin."""
    height, width, _ = background.shape
    lists, table, bg_chw, overflow = _scan_inputs(
        face_verts_screen, face_attrs, background, config
    )
    with jax.named_scope("dirt_raster_fwd"):
        pixels_chw, fid, zbuf = scan(lists, table, bg_chw)
    pixels = jnp.transpose(pixels_chw, (1, 2, 0))[:height, :width]
    return pixels, fid[:height, :width], zbuf[:height, :width], overflow


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def rasterize_screen(face_verts_screen, face_attrs, background, config):
    """Rasterize screen-space faces over a background image.

    Args:
        face_verts_screen: [F, 3, 4] f32 (x_s, y_s, z_ndc, invw).
        face_attrs: [F, 3, C] f32.
        background: [H, W, C] f32.
        config: RasterConfig (static).
    Returns:
        (pixels [H, W, C] f32,
         fid [H, W] int32 — face id per pixel, -1 = background (non-diff),
         zbuf [H, W] f32 — screen-space depth, BIG_Z at background
         (non-diff),
         overflow [] bool — True if any static bin/expand cap truncated
         faces, i.e. the image may be missing coverage. GL (the reference)
         can never drop triangles, so callers should treat True as "redo
         with ``suggest_config``'s caps" (non-diff)).
    """
    pixels, fid, zbuf, overflow = _forward_impl(
        face_verts_screen, face_attrs, background, config
    )
    return pixels, fid, zbuf, jnp.any(overflow)


def _fwd(face_verts_screen, face_attrs, background, config):
    pixels, fid, zbuf, overflow = _forward_impl(
        face_verts_screen, face_attrs, background, config
    )
    out = (pixels, fid, zbuf, jnp.any(overflow))
    return out, (face_verts_screen, face_attrs, pixels, fid, zbuf)


def _bwd(config, residuals, cotangents):
    """Every engine shares one backward: ``raster_bwd.backward_jax``.

    It needs only the forward's images (face id, depth, colour), not its
    bins: a row gather of each pixel's face planes, per-pixel cotangents,
    and a ``segment_sum`` onto faces.
    """
    face_verts_screen, face_attrs, pixels, fid, zbuf = residuals
    grad_pixels = cotangents[0]

    def planes(fv, fa):
        geo, att, _ = setup_planes(fv, fa)
        return geo, att

    with jax.named_scope("dirt_raster_bwd"):
        (geo, att), vjp_fn = jax.vjp(planes, face_verts_screen, face_attrs)
        d_geo, d_att, d_background = backward_jax(
            geo, att, fid, zbuf, pixels, grad_pixels
        )
        d_fv, d_fa = vjp_fn((d_geo, d_att))
    return d_fv, d_fa, d_background


rasterize_screen.defvjp(_fwd, _bwd)


def check_bin_overflow(face_verts_screen, face_attrs, background, config):
    """Returns the per-tile overflow flags for a given scene (diagnostics)."""
    return _scan_inputs(face_verts_screen, face_attrs, background, config)[3]


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def count_bins_exact(bbox, height, width, tile_h, tile_w):
    """Exact per-tile face counts + max per-face tile span, O(F + T).

    2D interval stabbing by inclusion-exclusion: each face adds +1/-1 at
    the four corners of its tile range in a difference grid; a double
    prefix sum recovers the per-tile counts. No [T, F] matrix, so this is
    cheap even for millions of faces — it is the "count" half of the
    count-then-allocate strategy (:func:`suggest_config`).
    """
    bbox = jnp.asarray(bbox, jnp.int32)
    tiles_y = -(-height // tile_h)
    tiles_x = -(-width // tile_w)
    txmin, txmax = bbox[:, 0] // tile_w, bbox[:, 1] // tile_w
    tymin, tymax = bbox[:, 2] // tile_h, bbox[:, 3] // tile_h
    valid = (bbox[:, 1] >= bbox[:, 0]) & (bbox[:, 3] >= bbox[:, 2])
    w = valid.astype(jnp.int32)
    diff = jnp.zeros((tiles_y + 1, tiles_x + 1), jnp.int32)
    diff = diff.at[tymin, txmin].add(w)
    diff = diff.at[tymin, txmax + 1].add(-w)
    diff = diff.at[tymax + 1, txmin].add(-w)
    diff = diff.at[tymax + 1, txmax + 1].add(w)
    counts = jnp.cumsum(jnp.cumsum(diff, axis=0), axis=1)
    counts = counts[:tiles_y, :tiles_x].reshape(-1)
    span = jnp.where(valid, (txmax - txmin + 1) * (tymax - tymin + 1), 0)
    return counts, jnp.max(span)


def _bbox_from_fv(fv, height, width):
    """Device-side [F, 4] bbox from screen verts (counting-stage helper)."""
    _, _, valid = setup_planes(
        fv, jnp.zeros((fv.shape[0], 3, 1), jnp.float32)
    )
    return face_bboxes(fv, valid, height, width)


def _subtile_spans(bbox, height, width, tile_h, tile_w):
    """(span_x, span_y, span, valid) at 8x16-subtile granularity."""
    hp = _pad_to(height, tile_h)
    wp = _pad_to(width, tile_w)
    tiles_y, tiles_x, strips, groups = binning.packed_grid(
        hp, wp, tile_h, tile_w
    )
    gy_n = tiles_y * strips
    gx_n = tiles_x * groups
    gxmin = jnp.clip(bbox[:, 0] // binning.SUB_W, 0, gx_n - 1)
    gxmax = jnp.clip(bbox[:, 1] // binning.SUB_W, 0, gx_n - 1)
    gymin = jnp.clip(bbox[:, 2] // binning.SUB_H, 0, gy_n - 1)
    gymax = jnp.clip(bbox[:, 3] // binning.SUB_H, 0, gy_n - 1)
    valid = (bbox[:, 1] >= bbox[:, 0]) & (bbox[:, 3] >= bbox[:, 2])
    span_x = jnp.where(valid, gxmax - gxmin + 1, 0)
    span_y = jnp.where(valid, gymax - gymin + 1, 0)
    return span_x, span_y, span_x * span_y, (gxmin, gymin)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _suggest_scalars(fv, height, width, tile_h, tile_w):
    """Counting stage 1: per-tile and per-face maxima, reduced on device.

    Only the three scalars the caps need come back to the host.
    """
    bbox = _bbox_from_fv(fv, height, width)
    counts, max_span = count_bins_exact(
        bbox, height, width, tile_h, tile_w
    )
    _, _, sub_span, _ = _subtile_spans(bbox, height, width, tile_h, tile_w)
    return jnp.max(counts), max_span, jnp.max(sub_span)


def suggest_config(
    face_verts_screen, height: int, width: int,
    config: RasterConfig | None = None, margin: float = 1.25,
):
    """Concrete RasterConfig whose caps cannot overflow for this scene.

    The "allocate" half of count-then-allocate: measures the exact
    per-tile bin occupancy and per-face tile span for the given geometry
    and returns ``config`` with ``bin_cap`` / ``expand_cap`` set just
    above the measured maxima (times ``margin`` headroom for scenes that
    move a little during optimization). Host-synchronizing — call it
    once OUTSIDE jit when ``rasterise_with_aux`` reports overflow (or
    ahead of time), then render with the returned config. All device
    work is jitted and all fetches are scalars (see _suggest_scalars).
    """
    config = (config or RasterConfig()).concrete(height)
    num_faces = face_verts_screen.shape[0]
    streaming = use_streaming(config, num_faces)
    engine = resolve_engine(config, num_faces)

    max_count, max_span, max_sub = jax.device_get(
        _suggest_scalars(
            face_verts_screen, height, width,
            config.tile_h, config.tile_w,
        )
    )
    max_count = int(max_count)
    cap = _pad_to(max(int(max_count * margin), 1), binning.CHUNK)
    kwargs = dict(bin_cap=cap)
    if streaming or config.streaming:
        kwargs["expand_cap"] = max(int(int(max_span) * margin), 1)
    if engine == "packed":
        # The packed engine's caps are SUBTILE-granular (8x16), not
        # tile-granular: measure the exact per-face subtile span, the
        # exact iteration demand (per-strip group-max summed, with
        # per-tile chunk-padding) and the exact candidate-pool size, so
        # the auto heuristics' overflow flag can always be silenced by
        # one count-then-allocate call (the auto expand cap of 8 truncates
        # the 10k-face 1024^2 bench sphere, whose true max span is 24).
        exp, bud, pool, work = count_packed_exact(
            None, height, width, config.tile_h, config.tile_w, margin,
            face_verts_screen=face_verts_screen,
            max_subspan=int(max_sub),
        )
        kwargs["expand_cap"] = exp
        kwargs["budget"] = bud
        kwargs["pool_cap"] = pool
        kwargs["work_cap"] = work
    return config._replace(**kwargs)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _max_subspan_scalar(height, width, tile_h, tile_w, bbox):
    _, _, span, _ = _subtile_spans(bbox, height, width, tile_h, tile_w)
    return jnp.max(span)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8))
def _count_packed_device(
    bbox, fv, height, width, tile_h, tile_w, e_max, expand, margin,
):
    """Counting stage 2 — device-side candidate enumeration, scalar out.

    Returns (budget, pool_blocks_sum, jobs_sum). Mirrors the candidate layout and
    the exact triangle-vs-subtile edge filter of
    ``binning.bin_faces_packed`` (same anchored edge planes, same
    half-pixel slack) so the budget counts the iterations the kernels
    actually execute.
    """
    if bbox is None:
        bbox = _bbox_from_fv(fv, height, width)
    bbox = jnp.asarray(bbox, jnp.int32)
    hp = _pad_to(height, tile_h)
    wp = _pad_to(width, tile_w)
    tiles_y, tiles_x, strips, groups = binning.packed_grid(
        hp, wp, tile_h, tile_w
    )
    nsid = tiles_y * tiles_x * strips * groups
    span_x, span_y, span, (gxmin, gymin) = _subtile_spans(
        bbox, height, width, tile_h, tile_w
    )
    al = binning.POOL_ALIGN
    blocks = -(-jnp.minimum(span, expand) // al)
    blocks_sum = jnp.sum(blocks)

    # Candidate enumeration [F, e_max] (e_max = true max span, fetched as
    # a scalar by the caller so the shape is static).
    e = jnp.arange(e_max, dtype=jnp.int32)[None, :]
    sx = jnp.maximum(span_x, 1)[:, None]
    ey = e // sx
    ex = e - ey * sx
    gy = gymin[:, None] + ey
    gx = gxmin[:, None] + ex
    ok = e < jnp.minimum(span, expand)[:, None]
    if fv is not None:
        x0, y0, a0, b0, a1, b1, a2, b2, c0 = edge_filter_cols(fv)
        rx0 = gx.astype(jnp.float32) * binning.SUB_W + 0.5 - x0[:, None]
        ry0 = gy.astype(jnp.float32) * binning.SUB_H + 0.5 - y0[:, None]
        zero = jnp.zeros_like(c0)
        for a, b, c in ((a0, b0, c0), (a1, b1, zero), (a2, b2, zero)):
            av, bv, cv = a[:, None], b[:, None], c[:, None]
            emax = (av * rx0 + bv * ry0 + cv
                    + jnp.maximum(av, 0.0) * (binning.SUB_W - 1)
                    + jnp.maximum(bv, 0.0) * (binning.SUB_H - 1))
            slack = 0.5 * jnp.sqrt(av * av + bv * bv)
            ok = ok & (emax >= -slack)
    t_id = (gy // strips) * tiles_x + gx // groups
    sid = (t_id * strips + gy % strips) * groups + gx % groups
    sid = jnp.where(ok, sid, nsid)
    counts = jnp.zeros((nsid + 1,), jnp.int32).at[sid.reshape(-1)].add(
        1, mode="drop"
    )[:nsid].reshape(tiles_y, strips, tiles_x, groups)
    n_iter = jnp.max(counts, axis=3)                  # [ty, strips, tx]
    tile_iters = jnp.sum(n_iter, axis=1)              # [ty, tx]
    ti_m = (tile_iters.astype(jnp.float32) * margin).astype(jnp.int32)
    chunks = jnp.maximum(-(-ti_m // binning.PACK_ITERS), 1)
    budget = jnp.sum(chunks) * binning.PACK_ITERS
    # Surviving (post-filter) jobs: the binning's live-prefix work_cap is
    # nsid headers + this many real pairs (see bin_faces_packed).
    jobs_sum = jnp.sum(counts)
    return budget, blocks_sum, jobs_sum


def count_packed_exact(bbox, height: int, width: int, tile_h: int,
                       tile_w: int, margin: float = 1.25,
                       face_verts_screen=None, max_subspan: int | None = None):
    """Exact (expand_cap, budget, pool_cap, work_cap) for the packed engine.

    Counting half of count-then-allocate at subtile granularity.
    Without geometry, per-subtile face counts come from the bbox ranges
    alone. With ``face_verts_screen`` given, candidates are run through
    the SAME edge-overlap filter the binning applies
    (``triangle_setup.edge_filter_cols`` + half-pixel slack), so the
    budget reflects the iterations the kernel actually executes — on
    the 1024^2 bench sphere the filter drops ~1/3 of bbox candidates.
    Per-(tile, strip) iteration demand is the max over the strip's 8
    column groups; the budget is the
    sum of per-tile demands rounded up to whole PACK_CHUNK chunks (each
    tile owns at least its init chunk, mirroring ``bin_faces_packed``).
    expand_cap / pool_cap stay bbox-based (the pool enumerates bbox
    candidates; filtering empties slots, it does not remove them).

    Host-synchronizing — call outside jit. All heavy math runs in two
    jitted device programs that return scalars.

    ``bbox`` may be None when ``face_verts_screen`` is given (derived on
    device); ``max_subspan`` skips the stage-1 scalar fetch when the
    caller already knows it (suggest_config).
    """
    if bbox is not None:
        bbox = jnp.asarray(bbox, jnp.int32)
    if max_subspan is None:
        if bbox is None:
            bbox = jax.jit(
                _bbox_from_fv, static_argnums=(1, 2)
            )(face_verts_screen, height, width)
        max_subspan = int(
            _max_subspan_scalar(height, width, tile_h, tile_w, bbox)
        )
    e_max = max(int(max_subspan), 1)
    expand = max(int(max_subspan * margin), 1)
    budget, blocks_sum, jobs_sum = jax.device_get(_count_packed_device(
        bbox, face_verts_screen, height, width, tile_h, tile_w,
        e_max, expand, float(margin),
    ))
    al = binning.POOL_ALIGN
    pool = int(int(blocks_sum) * margin + 1) * al
    hp = _pad_to(height, tile_h)
    wp = _pad_to(width, tile_w)
    tiles_y, tiles_x, strips, groups = binning.packed_grid(
        hp, wp, tile_h, tile_w
    )
    nsid = tiles_y * tiles_x * strips * groups
    work = nsid + int(int(jobs_sum) * margin) + 8
    return expand, int(budget), pool, work
