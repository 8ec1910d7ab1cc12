"""Tile binning: assign faces to image tiles (pure JAX, static shapes).

The reference leans on GL's hardware binning; here it is an explicit
pass (SURVEY.md sections 2.1 and 7). Overflow beyond the static caps is
*reported* (boolean flags), never silently dropped without a flag.

Three implementations; ``ops.raster_fwd`` turns each into per-block face
lists for the one scan kernel:

* ``bin_faces`` — dense: a [num_tiles, F] overlap matrix compacted per row
  with top_k. O(T*F) memory/work; the fastest option for small scenes
  (<~20k faces) and supports faces of any screen size.
* ``bin_faces_csr`` — scalable: expand each face into its (tile, face)
  overlap pairs (capped at ``expand_cap`` tiles per face), sort pairs by
  (tile, face), and lay the per-tile runs out in a chunk-padded CSR layout
  (each tile's run starts at a CHUNK-aligned row). O(F * E log) work,
  no T*F matrix — this is the production path for large meshes
  (nvdiffrast-style binned software rasterization; PAPERS.md "Modular
  Primitives", "CuRast").
* ``bin_faces_packed`` — per 8x16-pixel subtile lists, so a face only
  costs the subtiles it overlaps (see :class:`PackedBins`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

CHUNK = 128  # CSR run alignment (rows)

# Packed-subtile geometry: jobs are (face, 8x16-pixel subtile) pairs; 8
# column groups of 16 pixels tile a 128-wide strip row.
SUB_H = 8
SUB_W = 16
GROUPS = 8               # 128-column tile width / SUB_W
# Each tile's packed run is padded to whole chunks of 64 iterations.
PACK_CHUNK = 512
POOL_ALIGN = 4    # candidate-pool slots per per-face run block
PACK_ITERS = PACK_CHUNK // GROUPS  # 64 iterations per packed chunk


class BinningResult(NamedTuple):
    bins: jax.Array      # [num_tiles, cap] int32, face index or F (sentinel)
    counts: jax.Array    # [num_tiles] int32, clamped to cap
    overflow: jax.Array  # [num_tiles] bool, True where count exceeded cap


def _scan_sum(x, axis=0):
    """Prefix sum via log-depth associative_scan.

    associative_scan emits ~log2(n) shifted vector adds in place of the
    reduce-window pass XLA uses for jnp.cumsum/cummax; the two have not
    been compared on the GPU.
    """
    return jax.lax.associative_scan(jnp.add, x, axis=axis)


def _bbox_cols(bbox):
    """(xmin, xmax, ymin, ymax) from a 4-tuple or a stacked [F, 4] array.

    Production passes the tuple (column reads on a stacked [F, 4] array
    scalarize into a column-major relayout); the stacked form stays
    supported for tests and tooling.
    """
    if isinstance(bbox, (tuple, list)):
        return tuple(jnp.asarray(c, jnp.int32) for c in bbox)
    bbox = jnp.asarray(bbox, jnp.int32)
    return bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]


def num_tiles(height: int, width: int, tile_h: int, tile_w: int):
    return (-(-height // tile_h), -(-width // tile_w))


def bin_faces(
    bbox, height: int, width: int, tile_h: int, tile_w: int, cap: int
) -> BinningResult:
    """Bin faces by conservative bbox/tile overlap.

    Args:
        bbox: [F, 4] int32 (xmin, xmax, ymin, ymax) inclusive pixel indices;
            empty boxes have max < min.
    """
    bxmin, bxmax, bymin, bymax = _bbox_cols(bbox)
    nf = bxmin.shape[0]
    tiles_y, tiles_x = num_tiles(height, width, tile_h, tile_w)
    total = tiles_y * tiles_x

    txmin = bxmin // tile_w
    txmax = bxmax // tile_w
    tymin = bymin // tile_h
    tymax = bymax // tile_h

    tile_ids = jnp.arange(total, dtype=jnp.int32)
    tx = tile_ids % tiles_x
    ty = tile_ids // tiles_x

    overlap = (
        (txmin[None, :] <= tx[:, None])
        & (tx[:, None] <= txmax[None, :])
        & (tymin[None, :] <= ty[:, None])
        & (ty[:, None] <= tymax[None, :])
    )  # [total, F]

    raw_counts = jnp.sum(overlap, axis=1, dtype=jnp.int32)
    overflow = raw_counts > cap
    counts = jnp.minimum(raw_counts, cap)

    # Left-compact each row's set bits into face-id lists. top_k on a key
    # that is positive exactly on overlaps and decreasing in face index
    # yields the first `cap` overlapping ids in ascending order.
    face_ids = jax.lax.broadcasted_iota(jnp.int32, (total, nf), 1)
    key = jnp.where(overlap, nf - face_ids, 0)
    val, idx = jax.lax.top_k(key, cap)
    bins = jnp.where(val > 0, idx, nf).astype(jnp.int32)
    return BinningResult(bins=bins, counts=counts, overflow=overflow)


class CSRBins(NamedTuple):
    """Chunk-padded CSR tile bins.

    ``entry_face[start_block[t] * CHUNK + i]`` for ``i < counts[t]`` are the
    face ids overlapping tile ``t`` in ascending order; slots between
    ``counts[t]`` and the next tile's start hold the sentinel id F. Every
    tile's run begins at a CHUNK-aligned row.
    """

    entry_face: jax.Array   # [n_pad] int32, sentinel = F
    start_block: jax.Array  # [num_tiles] int32, in units of CHUNK rows
    counts: jax.Array       # [num_tiles] int32, clamped to cap
    overflow: jax.Array     # [] bool — any tile over cap OR face over
                            # expand_cap (its tail tiles were dropped)


def csr_pad_bound(num_faces: int, expand_cap: int, num_tiles: int) -> int:
    """Static upper bound on the padded CSR length."""
    pairs = num_faces * expand_cap
    return -(-pairs // CHUNK) * CHUNK + num_tiles * CHUNK


def auto_expand_cap(num_faces: int, num_tiles: int) -> int:
    """Default per-face tile-overlap cap.

    Expansion work is O(F * E), so large meshes (whose triangles are
    necessarily small relative to the tile grid) get a tight cap; low-poly
    scenes get one that lets a single face span the whole grid. Faces
    spanning more tiles than the cap are truncated and flagged via
    ``overflow`` — raise ``RasterConfig.expand_cap`` for scenes mixing
    huge triangle counts with individually huge triangles.
    """
    if num_faces > 65536:
        return 8
    target = max(16, (16 * num_tiles) // max(num_faces, 1))
    cap = 16
    while cap < target and cap < num_tiles:
        cap *= 2
    return min(max(cap, 16), max(num_tiles, 16))


def bin_faces_csr(
    bbox, height: int, width: int, tile_h: int, tile_w: int, cap: int,
    expand_cap: int,
) -> CSRBins:
    """Scalable pair-expansion binning (see module docstring).

    Args:
        bbox: [F, 4] int32 (xmin, xmax, ymin, ymax) inclusive pixel indices;
            empty boxes have max < min.
        cap: per-tile face cap (clamped, overflow-flagged); rounded up to a
            CHUNK multiple.
        expand_cap: max tiles a single face may overlap (truncated beyond,
            overflow-flagged).
    """
    bxmin, bxmax, bymin, bymax = _bbox_cols(bbox)
    nf = bxmin.shape[0]
    tiles_y, tiles_x = num_tiles(height, width, tile_h, tile_w)
    total = tiles_y * tiles_x
    cap = -(-cap // CHUNK) * CHUNK
    n_pad = csr_pad_bound(nf, expand_cap, total)

    txmin = bxmin // tile_w
    txmax = bxmax // tile_w
    tymin = bymin // tile_h
    tymax = bymax // tile_h
    valid = (bxmax >= bxmin) & (bymax >= bymin)
    span_x = jnp.where(valid, txmax - txmin + 1, 0)
    span_y = jnp.where(valid, tymax - tymin + 1, 0)
    n_e = span_x * span_y
    face_overflow = n_e > expand_cap

    # Expand: pair e of face f covers tile (tymin + e // span_x,
    # txmin + e % span_x); pairs beyond n_e (or expand_cap) get the
    # sentinel tile id `total` and sort to the end.
    e = jnp.arange(expand_cap, dtype=jnp.int32)[None, :]          # [1, E]
    sx = jnp.maximum(span_x, 1)[:, None]
    ey = e // sx
    ex = e - ey * sx
    tile = (tymin[:, None] + ey) * tiles_x + (txmin[:, None] + ex)
    pair_valid = e < jnp.minimum(n_e, expand_cap)[:, None]
    tile = jnp.where(pair_valid, tile, total).astype(jnp.int32)   # [F, E]
    face = jnp.broadcast_to(
        jnp.arange(nf, dtype=jnp.int32)[:, None], tile.shape
    )

    tile_s, face_s = jax.lax.sort(
        (tile.reshape(-1), face.reshape(-1)), num_keys=2
    )
    npairs = tile_s.shape[0]

    # Per-tile raw counts / raw starts (T-sized vectorized binary search).
    tile_ids = jnp.arange(total, dtype=jnp.int32)
    starts_raw = jnp.searchsorted(tile_s, tile_ids).astype(jnp.int32)
    ends_raw = jnp.searchsorted(tile_s, tile_ids, side="right")
    counts_raw = (ends_raw - starts_raw).astype(jnp.int32)
    overflow = jnp.any(counts_raw > cap) | jnp.any(face_overflow & valid)
    counts = jnp.minimum(counts_raw, cap)
    padded_counts = -(-counts // CHUNK) * CHUNK
    start_block = (
        jnp.concatenate([jnp.zeros((1,), jnp.int32),
                         jnp.cumsum(padded_counts)[:-1]]) // CHUNK
    ).astype(jnp.int32)

    # Per-pair destination without an [npairs]-sized gather from a small
    # table: rank within run via cummax of run starts, and
    # the cumulative pad correction via a cumsum of per-run deltas placed
    # at run starts.
    iota = jnp.arange(npairs, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), tile_s[1:] != tile_s[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(is_start, iota, 0))
    rank = iota - run_start
    # At each run start: pad delta of the PREVIOUS run
    # (padded(min(raw, cap)) - raw); raw = this_start - prev_start.
    prev_start = jnp.concatenate([jnp.zeros((1,), jnp.int32), run_start[:-1]])
    prev_raw = jnp.where(is_start, iota - prev_start, 0)
    prev_capped = jnp.minimum(prev_raw, cap)
    prev_padded = -(-prev_capped // CHUNK) * CHUNK
    delta = jnp.where(is_start, prev_padded - prev_raw, 0)
    delta = delta.at[0].set(0)
    cum_pad = jnp.cumsum(delta)
    dest = run_start + cum_pad + rank

    keep = (tile_s < total) & (rank < cap)
    dest = jnp.where(keep, dest, n_pad - 1)
    entry_face = jnp.full((n_pad,), nf, jnp.int32)
    entry_face = entry_face.at[dest].set(jnp.where(keep, face_s, nf))
    # Reset the dump slot (clobbered by dropped pairs). No kept pair can
    # land there: sum of padded runs <= ceil(F*E/CHUNK)*CHUNK +
    # T*(CHUNK-1) = n_pad - T < n_pad.
    entry_face = entry_face.at[n_pad - 1].set(nf)

    return CSRBins(
        entry_face=entry_face,
        start_block=start_block,
        counts=counts,
        overflow=overflow,
    )


class PackedBins(NamedTuple):
    """Packed subtile bins (the packed engine).

    The image is carved into 8x16-pixel subtiles: strip s of tile t covers
    rows 8s..8s+8, and each 128-wide strip row holds 8 column GROUPS of 16
    columns. One ITERATION of a strip holds 8 jobs — one (face, subtile)
    pair per group — that the scan kernel evaluates together over the
    strip's 8x128 block. A face only pays for the subtiles its bbox
    overlaps (8x16 granularity) instead of whole 64x128 tiles.

    ``entries[8 * i + g]`` is the packed job of iteration ``i``, group
    ``g``: ``face_id * 8 + strip`` (strip < 8 because tile_h <= 64), with
    the sentinel face ``F`` on empty slots. Iterations are laid out
    contiguously per tile — strips in ascending order, ranks within a
    (strip, group) run in ascending face order (preserving the dense
    path's z-tie rule) — and each tile's run is padded to whole
    PACK_CHUNKs.
    """

    entries: jax.Array      # [budget_rows] int32, face * 8 + strip
    start_block: jax.Array  # [num_tiles] int32, first chunk of the tile
    n_iters: jax.Array      # [num_tiles] int32, real iterations (un-padded)
    overflow: jax.Array     # [] bool
    iter_off: jax.Array     # [num_tiles * strips] int32: first iteration
                            # (tile-local) of each strip's contiguous run
    strip_iters: jax.Array  # [num_tiles * strips] int32: run length


def packed_grid(height: int, width: int, tile_h: int, tile_w: int):
    """(tiles_y, tiles_x, strips_per_tile, groups) for the packed layout."""
    tiles_y, tiles_x = num_tiles(height, width, tile_h, tile_w)
    return tiles_y, tiles_x, tile_h // SUB_H, tile_w // SUB_W


def auto_packed_budget(num_faces: int, height: int, width: int,
                       tile_h: int, tile_w: int,
                       expand_cap: int | None = None) -> int:
    """Default iteration budget (static row storage = 8 * budget).

    Iterations ~= jobs / 8 x imbalance; for the dense-mesh regime the
    packed engine targets (small triangles, ~4 subtile jobs each) that is
    ~F/2, so F iterations is a 2x margin. The NSID/4 term covers
    moderate-coverage scenes; genuinely low-poly/full-screen scenes
    should use the dense engine (RasterConfig.engine). Overflow is
    flagged; ``suggest_config`` measures the exact requirement.
    """
    tiles_y, tiles_x, strips, groups = packed_grid(
        height, width, tile_h, tile_w
    )
    total = tiles_y * tiles_x
    nsid = total * strips * groups
    # The nsid/8 term covers moderate-coverage scenes; the PACK_ITERS/2
    # term pays for expected per-tile chunk-granularity padding. Slack is
    # not free: binning cost scales with the budget, so the margin is
    # modest and overflow-flagged.
    budget = num_faces + nsid // 8 + total * (PACK_ITERS // 2)
    if expand_cap is not None:
        # Hard job-count bound: jobs <= F * E, iterations <= jobs (all in
        # one group) but ~jobs/8 * imbalance in practice; 2x margin over
        # the balanced estimate plus per-tile padding slack.
        bound = (num_faces * expand_cap) // GROUPS * 2 + total * PACK_ITERS
        if num_faces * expand_cap >= 32 * nsid:
            # Dense regime (>= 32 jobs per subtile on average): the
            # per-strip group-max tracks the group-mean closely, so a
            # 1.4x margin suffices; every per-budget-row cost scales
            # with this number. Overflow stays flagged and
            # suggest_config still measures the exact requirement.
            bound = min(
                bound,
                (num_faces * expand_cap) // GROUPS * 7 // 5
                + total * PACK_ITERS,
            )
        budget = min(budget, bound)
    # Floor: every tile needs at least one chunk for its init step.
    budget = max(budget, (total + 2) * PACK_ITERS)
    return -(-budget // PACK_ITERS) * PACK_ITERS


def auto_packed_expand(num_faces: int, nsid: int) -> int:
    """Max subtile jobs per face. Tight for dense meshes (pairs-sort and
    placement-scatter cost scale with F * E); generous for small F."""
    if num_faces > 4096:
        # At small resolutions (few subtiles) a dense mesh's triangles
        # are tiny — 2x2 subtile spans cover them and the pair count
        # (the binning sort/scatter cost) halves.
        return 4 if nsid < 4096 else 8
    target = max(32, (8 * nsid) // max(num_faces, 1))
    cap = 32
    while cap < target and cap < nsid:
        cap *= 2
    return min(cap, max(nsid, 32))


def auto_pool_cap(num_faces: int, expand_cap: int) -> int:
    """Default flat-pool slot budget for :func:`bin_faces_packed`.

    Capacity for ~8 slots/face mean (covers dense-mesh spans after
    POOL_ALIGN padding), floored for tiny meshes and never more than
    every face at its full expand cap. Overflow is flagged;
    ``suggest_config`` measures the exact requirement.
    """
    cap = min(num_faces * expand_cap, max(8 * num_faces, 32768))
    return -(-cap // POOL_ALIGN) * POOL_ALIGN


def bin_faces_packed(
    bbox, height: int, width: int, tile_h: int, tile_w: int,
    budget_iters: int, expand_cap: int,
    edges=None, pool_cap: int | None = None,
    work_cap: int | None = None, _stage: int = 0,
) -> PackedBins:
    """Lane-packed subtile binning (see :class:`PackedBins`).

    Pipeline (sorts and cummaxes in place of scatters and searchsorted
    wherever the two are interchangeable):

    1. enumerate (subtile sid, face) candidates into a FLAT POOL of
       8-aligned per-face runs (cost scales with actual jobs, not
       F * worst-case span), capped at ``expand_cap`` jobs per face and
       ``pool_cap`` total slots (both overflow-flagged); with ``edges``
       given, bbox candidates failing the exact triangle-vs-subtile
       overlap test are dropped here;
    2. ONE merged sort of pairs + one header record per sid — headers
       (face = -1) sort to the front of each sid run;
    3. run lengths (= per-subtile counts) read off at run ends, compacted
       by a second small sort, scattered onto the [T, S, G] grid (only
       NSID updates);
    4. grid-level prefix math (max over groups -> iterations per strip ->
       per-tile chunk spans, water-filled so every tile keeps >= 1 chunk
       even when the budget overflows);
    5. per-pair placement: run starts (prefix sums over sid) scattered at
       nsid header slots + cummax give every sorted pair its budget row
       (block-row = strip start + in-run rank, lane = sid % groups);
    6. entries are BUILT BY ONE PAIR SCATTER onto strip-aware sentinel
       defaults.

    ``work_cap``: every stage AFTER the merged sort runs on the
    first ``work_cap`` sorted elements only. Invalid candidates — empty
    pool slots, edge-filtered bbox candidates, truncated jobs — carry the
    sentinel sid ``nsid`` and sort to the END, so a cap of
    (nsid + real_jobs * margin) covers all live content: the rank
    cummaxes, the counts compaction sort, the placement math and the
    entries scatter stop paying for the dead tail (~half the merged array
    at honest caps, where the pool is sized for bbox candidates but
    ~1/3 are edge-filtered). Headers always sort inside any prefix that
    holds live pairs (a run's header precedes its pairs), so truncation
    under an undersized cap is CLEAN — whole tail pairs drop, flagged
    via ``overflow`` (the element at position ``work_cap`` is still
    live). None = no slicing (exact); ``suggest_config`` measures the
    exact requirement.

    ``_stage`` > 0 returns early with a checksum scalar after pipeline
    stage N (profiling hook for tools/prof_binning.py — cumulative stage
    timings without duplicating this function).
    """
    bxmin, bxmax, bymin, bymax = _bbox_cols(bbox)
    nf = bxmin.shape[0]
    tiles_y, tiles_x, strips, groups = packed_grid(
        height, width, tile_h, tile_w
    )
    total = tiles_y * tiles_x
    nsid = total * strips * groups
    gy_max_all = tiles_y * strips - 1
    gx_max_all = tiles_x * groups - 1
    budget_rows = budget_iters * GROUPS
    budget_chunks = budget_rows // PACK_CHUNK
    assert budget_chunks >= total, (
        "packed budget must give every tile an init chunk"
    )

    # --- 1. candidate pool (flat, 8-aligned per-face runs) -------------
    # Candidates used to live in a uniform [F, expand_cap] grid, which
    # priced EVERY face at the worst face's span (honest caps on the
    # 10k-face 1024^2 bench scene need expand = 25). The pool
    # instead gives face f a POOL_ALIGN-aligned run of its own n_jobs
    # slots at a cumsum offset, so total work scales with ACTUAL jobs.
    # Slot -> face resolves by a start-marker scatter (F updates) +
    # cummax, and per-face fields arrive via ONE [pool, 8/16]-wide row
    # gather.
    valid = (bxmax >= bxmin) & (bymax >= bymin)
    gxmin = jnp.clip(bxmin // SUB_W, 0, gx_max_all)
    gxmax = jnp.clip(bxmax // SUB_W, 0, gx_max_all)
    gymin = jnp.clip(bymin // SUB_H, 0, gy_max_all)
    gymax = jnp.clip(bymax // SUB_H, 0, gy_max_all)
    span_x = jnp.where(valid, gxmax - gxmin + 1, 0)
    span_y = jnp.where(valid, gymax - gymin + 1, 0)
    n_jobs = span_x * span_y
    face_overflow = valid & (n_jobs > expand_cap)
    njobs_c = jnp.minimum(n_jobs, expand_cap)

    if pool_cap is None:
        pool_cap = auto_pool_cap(nf, expand_cap)
    al = POOL_ALIGN
    pool_cap = max(-(-pool_cap // al) * al, al)
    pool_blocks = pool_cap // al

    blocks = -(-njobs_c // al)                       # [F], slot blocks
    boff = jnp.cumsum(blocks) - blocks               # exclusive, blocks
    pool_overflow = jnp.sum(blocks) > pool_blocks

    start_ok = (blocks > 0) & (boff < pool_blocks)
    fidx = jnp.arange(nf, dtype=jnp.int32)
    slot0 = jnp.where(start_ok, boff * al, pool_cap).astype(jnp.int32)
    neg_pool = jnp.full((pool_cap,), -1, jnp.int32)
    face_of = jax.lax.cummax(neg_pool.at[slot0].set(fidx, mode="drop"))
    s0_of = jax.lax.cummax(neg_pool.at[slot0].set(slot0, mode="drop"))
    if _stage == 11:
        return jnp.sum(face_of) + jnp.sum(s0_of)

    # Per-face fields, one row gather (ints are exact in f32 < 2^24).
    ftbl_cols = [
        gxmin.astype(jnp.float32), gymin.astype(jnp.float32),
        jnp.maximum(span_x, 1).astype(jnp.float32),
        njobs_c.astype(jnp.float32),
    ]
    if edges is not None:
        ftbl_cols += [jnp.asarray(c, jnp.float32) for c in edges]
    pad_cols = (-len(ftbl_cols)) % 8
    ftbl = jnp.stack(
        ftbl_cols + [jnp.zeros((nf,), jnp.float32)] * pad_cols, axis=1
    )
    frow = ftbl[jnp.clip(face_of, 0, nf - 1)]        # [pool_cap, 8/16]
    # One explicit transpose makes every per-field read below a
    # contiguous row slice instead of a strided column read.
    frow_t = frow.T                                  # [8/16, pool_cap]

    p_iota = jnp.arange(pool_cap, dtype=jnp.int32)
    e = p_iota - s0_of                               # candidate rank
    sx = jnp.maximum(frow_t[2].astype(jnp.int32), 1)
    # e // sx via f32 division + one fixup step: int32 division lowers to
    # a long instruction sequence. Both
    # operands are < 2^17 so the f32 quotient is within one ulp of the
    # true value and can only err by rounding UP across an integer
    # boundary — ey * sx > e detects exactly that case.
    ey = (e.astype(jnp.float32) / frow_t[2]).astype(jnp.int32)
    ey = jnp.where(ey * sx > e, ey - 1, ey)
    ex = e - ey * sx
    gy = frow_t[1].astype(jnp.int32) + ey
    gx = frow_t[0].astype(jnp.int32) + ex
    pair_ok = (face_of >= 0) & (e < frow_t[3].astype(jnp.int32))
    if _stage == 12:
        return jnp.sum(gy) + jnp.sum(gx) + jnp.sum(pair_ok)
    if edges is not None:
        # Exact conservative triangle-vs-subtile overlap test: drop bbox
        # candidates whose 8x16 pixel-center rect lies more than half a
        # pixel outside any edge half-plane (same anchored edge planes
        # the kernels test — triangle_setup.edge_filter_cols). False
        # acceptance only costs kernel time; the half-pixel slack makes
        # false rejection impossible under f32 rounding. Cuts the
        # silhouette-heavy tail of bbox jobs (~1/3 on the bench sphere).
        # All three edges evaluate as ONE stacked [3, pool] chain instead
        # of ~30 separate small XLA ops.
        rx0 = gx.astype(jnp.float32) * SUB_W + 0.5 - frow_t[4]
        ry0 = gy.astype(jnp.float32) * SUB_H + 0.5 - frow_t[5]
        a3 = frow_t[6:12:2]                                # [3, pool]
        b3 = frow_t[7:12:2]
        c3 = jnp.concatenate(
            [frow_t[12:13], jnp.zeros((2, pool_cap), jnp.float32)]
        )
        emax = (a3 * rx0[None] + b3 * ry0[None] + c3
                + jnp.maximum(a3, 0.0) * (SUB_W - 1)
                + jnp.maximum(b3, 0.0) * (SUB_H - 1))
        slack = 0.5 * jnp.sqrt(a3 * a3 + b3 * b3)
        pair_ok = pair_ok & jnp.all(emax >= -slack, axis=0)
    if _stage == 13:
        return jnp.sum(gy) + jnp.sum(gx) + jnp.sum(pair_ok)
    t_id = (gy // strips) * tiles_x + gx // groups
    sid_p = jnp.where(
        pair_ok,
        (t_id * strips + gy % strips) * groups + gx % groups,
        nsid,
    ).astype(jnp.int32)
    face_p = jnp.maximum(face_of, 0)
    if _stage == 1:
        return jnp.sum(sid_p) + jnp.sum(face_p)

    # --- 2. merged sort #1: pairs + headers ----------------------------
    hdr_sid = jnp.arange(nsid, dtype=jnp.int32)
    hdr_face = jnp.full((nsid,), -1, jnp.int32)
    sid_all = jnp.concatenate([sid_p, hdr_sid])
    face_all = jnp.concatenate([face_p, hdr_face])
    sid_s, face_s = jax.lax.sort((sid_all, face_all), num_keys=2)
    n_sorted = sid_s.shape[0]

    # Live-prefix slice (see docstring): every stage below runs on the
    # first C sorted elements; sentinel-sid candidates sort to the end.
    if work_cap is not None:
        c_live = min(
            max(-(-work_cap // 8) * 8, nsid + POOL_ALIGN), n_sorted
        )
    else:
        c_live = n_sorted
    if c_live < n_sorted:
        work_overflow = sid_s[c_live] < nsid
        sid_s = sid_s[:c_live]
        face_s = face_s[:c_live]
    else:
        work_overflow = jnp.bool_(False)
    n_merged = c_live

    iota = jnp.arange(n_merged, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sid_s[1:] != sid_s[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(is_start, iota, 0))
    rank = iota - run_start            # header rank 0, real pairs 1..len
    is_end = jnp.concatenate([sid_s[1:] != sid_s[:-1], jnp.ones((1,), bool)])
    if _stage == 2:
        return jnp.sum(rank) + jnp.sum(face_s) + jnp.sum(is_end)

    # --- 3. per-subtile counts via compaction sort + tiny scatter -----
    end_key = jnp.where(is_end & (sid_s < nsid), sid_s, nsid)
    key_c, len_c = jax.lax.sort((end_key, rank), num_keys=1)
    counts = jnp.zeros((nsid,), jnp.int32).at[key_c[:nsid]].set(
        len_c[:nsid], mode="drop"
    ).reshape(total, strips, groups)
    if _stage == 3:
        return jnp.sum(counts) + jnp.sum(rank)

    # --- 4. grid prefix math ------------------------------------------
    n_iter = jnp.max(counts, axis=2)                        # [T, S]
    iter_off = _scan_sum(n_iter, axis=1) - n_iter       # exclusive
    tile_iters = jnp.sum(n_iter, axis=1)                    # [T]
    # Every tile owns >= 1 chunk (its init step), even when empty; the
    # cumulative layout must count those forced chunks or consecutive
    # empty tiles would collide on one chunk and lose their init.
    raw_chunks = jnp.maximum(-(-tile_iters // PACK_ITERS), 1)
    cum_excl = _scan_sum(raw_chunks) - raw_chunks
    t_idx = jnp.arange(total, dtype=jnp.int32)
    # Water-fill: reserve one chunk per remaining tile so every tile owns
    # at least one chunk even under budget overflow.
    base = jnp.minimum(cum_excl, budget_chunks - (total - t_idx))
    end = jnp.minimum(base + raw_chunks,
                      budget_chunks - (total - 1 - t_idx))
    end = jnp.maximum(end, base + 1)
    chunks_eff = end - base
    n_iters_eff = jnp.minimum(tile_iters, PACK_ITERS * chunks_eff)
    start_block = base.astype(jnp.int32)

    base_rows = base * PACK_CHUNK
    limit_rows = end * PACK_CHUNK
    rowstart = (
        base_rows[:, None, None]
        + GROUPS * iter_off[:, :, None]
        + jnp.arange(groups, dtype=jnp.int32)[None, None, :]
    )                                                        # [T, S, G]
    if _stage == 4:
        return (jnp.sum(rowstart) + jnp.sum(limit_rows)
                + jnp.sum(n_iters_eff) + jnp.sum(rank))

    # --- 5. pair placement via per-run cummax --------------------------
    # For sorted pair p of subtile sid with in-run rank k = rank - 1, its
    # budget position is block-row j = x8[sid] + k, lane g = sid % groups,
    # i.e. row 8 j + g (bijective on valid pairs: strip runs are disjoint
    # row ranges and ranks are dense within a run). Per-run x8 /
    # row-limit values spread scatter-free: sid h's header sits at sorted
    # position a_start[h] (runs are header-inclusive, so a_start is
    # strictly increasing and header slots are distinct), both fields are
    # non-decreasing in sid, so an nsid-slot scatter + cummax propagates
    # them to every pair of the run (entries scatter, step 6).
    r8 = budget_rows // GROUPS
    counts_flat = counts.reshape(-1)                      # [nsid]
    run_len = counts_flat + 1                             # + header
    a_start = _scan_sum(run_len) - run_len                # [nsid]

    limit8_sid = jnp.broadcast_to(
        (limit_rows // GROUPS)[:, None, None], (total, strips, groups)
    ).reshape(-1)
    x8_sid = jnp.broadcast_to(
        (rowstart[:, :, 0] // GROUPS)[:, :, None],
        (total, strips, groups),
    ).reshape(-1)
    # mode="drop": under work_cap overflow a late sid's header (and with
    # it the run's every pair) can sit past the live prefix.
    neg_m = jnp.full((n_merged,), -1, jnp.int32)
    x8_run = jax.lax.cummax(neg_m.at[a_start].set(x8_sid, mode="drop"))
    lim8_run = jax.lax.cummax(
        neg_m.at[a_start].set(limit8_sid, mode="drop")
    )
    k_p = rank - 1
    j_p = x8_run + k_p
    sid_c = jnp.minimum(sid_s, nsid - 1)
    # Overflow spill guard: rows at/past the tile's chunk allocation are
    # dropped (their jobs are already counted by the n_iters_eff
    # truncation flag).
    valid_p = (
        (rank >= 1) & (face_s >= 0) & (sid_s < nsid)
        & (x8_run >= 0) & (j_p < lim8_run)
    )
    row_val = jnp.where(
        valid_p, j_p * GROUPS + sid_c % groups, budget_rows
    ).astype(jnp.int32)
    if _stage == 5:
        return jnp.sum(row_val) + jnp.sum(rank)

    # --- 6. entries: strip-aware defaults + ONE pair scatter ----------
    # Strip index per block-row (strip starts are 8-row-aligned), for the
    # sentinel defaults: empty rows must carry their strip's index so the
    # kernels' strip-run arithmetic stays consistent.
    strip_start8 = rowstart[:, :, 0].reshape(-1) // GROUPS  # [T*S]
    strip_ok = (n_iter.reshape(-1) > 0) & (
        strip_start8
        < jnp.broadcast_to(
            (limit_rows // GROUPS)[:, None], (total, strips)
        ).reshape(-1)
    )
    smarks = jnp.zeros((r8,), jnp.int32).at[
        jnp.where(strip_ok, strip_start8, r8)
    ].add(1, mode="drop")
    s_row8 = (_scan_sum(smarks) - 1) % strips             # [r8]

    # sid = (t * strips + s) * groups + g  =>  (sid // groups) % strips
    # is the pair's strip (groups/strips are powers of two: shift+mask).
    value = face_s * 8 + (sid_c // groups) % strips
    defaults = jnp.broadcast_to(
        (nf * 8 + s_row8)[:, None], (r8, GROUPS)
    ).reshape(-1).astype(jnp.int32)
    entries = defaults.at[row_val].set(
        value.astype(jnp.int32), mode="drop"
    )
    if _stage == 6:
        return jnp.sum(entries) + jnp.sum(rank)

    if _stage == 7:
        return jnp.sum(entries)

    # Truncated jobs (rows past a tile's chunk allocation) are exactly the
    # tiles with n_iters_eff < tile_iters: a job of tile-local iteration i
    # fits iff i < chunks_eff * PACK_ITERS.
    overflow = (
        jnp.any(face_overflow)
        | jnp.any(n_iters_eff < tile_iters)
        | pool_overflow
        | work_overflow
    )
    return PackedBins(
        entries=entries,
        start_block=start_block,
        n_iters=n_iters_eff.astype(jnp.int32),
        overflow=overflow,
        iter_off=iter_off.reshape(-1).astype(jnp.int32),
        strip_iters=n_iter.reshape(-1).astype(jnp.int32),
    )
