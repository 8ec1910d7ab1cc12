"""Forward scan conversion: one Pallas kernel (Triton route) and its plain twin.

Equivalent of the reference's GL forward op (``csrc/rasterise_egl.cpp`` —
REGISTER_OP("Rasterise"); SURVEY.md section 2.1). Every engine's binning
(``ops.binning``: dense, CSR, packed) is reduced to the same shape here: a
grid of pixel BLOCKS of ``BLOCK_H x tile_w`` image pixels, and for each
block a LIST of face ids, read as ``ids[base + k * groups + g]`` for list
slot ``k < count`` and column group ``g = column // (tile_w // groups)``.
Dense and CSR bins have one group (the whole strip walks its tile's list);
packed bins have 8 groups of 16 columns, each walking its own 8x16
subtile's list in lockstep.

``raster_forward`` runs a Triton kernel: one program per block keeps z,
face id and the C attribute values of its pixels in registers while it
walks the list, loading each face's plane row by id from the face table
(a few MB at most, L2-resident). Faces are visited in ascending id order
within each list, so on exact z ties the lowest face id wins.

``raster_forward_xla`` is the same semantics as a plain ``lax.fori_loop``
over list slots that evaluates every block's pixels per step; it is the
reference the kernel is checked against on the card.

Layouts: images are channels-first [C, H, W] inside the op; the public
wrapper converts from/to [H, W, C].
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from dirt_tpu import config as cfg
from dirt_tpu.ops import binning
from dirt_tpu.ops.triangle_setup import GEO_USED

BIG_Z = 3.0e38  # z-buffer clear value (acts as +inf in f32 compares)

# Image rows per kernel program. One packed strip is SUB_H rows, so the
# packed engine's blocks must be exactly this tall; the dense and CSR
# engines split each bin tile into tile_h / BLOCK_H programs that walk the
# same list.
BLOCK_H = binning.SUB_H
# Warps per program: 4 was fastest or tied on every bench scene of an H100
# sweep over 1, 2, 4 and 8 (PERF.md).
NUM_WARPS = 4


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["ids", "base", "count"], meta_fields=["groups", "id_shift"],
)
@dataclasses.dataclass(frozen=True)
class FaceLists:
    """Per-block face lists (see module docstring).

    ``ids >> id_shift`` is a face id in [0, F]; F is the sentinel face
    (its table row covers nothing). ``groups`` and ``id_shift`` are static.
    """

    ids: jax.Array    # [N] int32 list storage
    base: jax.Array   # [Hp / BLOCK_H, Wp / tile_w] int32 first slot
    count: jax.Array  # [Hp / BLOCK_H, Wp / tile_w] int32 list length
    groups: int       # column groups per block (static)
    id_shift: int     # right shift that turns a stored entry into a face id


def _per_block(tile_vals, tiles_y, tiles_x, strips):
    """[T] per-tile values -> [tiles_y * strips, tiles_x] per block."""
    v = tile_vals.reshape(tiles_y, 1, tiles_x)
    return jnp.broadcast_to(v, (tiles_y, strips, tiles_x)).reshape(
        tiles_y * strips, tiles_x
    ).astype(jnp.int32)


def dense_lists(bins: binning.BinningResult, tiles_y, tiles_x, tile_h):
    """Face lists of the dense engine: row t of ``bins.bins`` per tile."""
    total, cap = bins.bins.shape
    strips = tile_h // BLOCK_H
    base = jnp.arange(total, dtype=jnp.int32) * cap
    return FaceLists(
        ids=bins.bins.reshape(-1),
        base=_per_block(base, tiles_y, tiles_x, strips),
        count=_per_block(bins.counts, tiles_y, tiles_x, strips),
        groups=1, id_shift=0,
    )


def csr_lists(bins: binning.CSRBins, tiles_y, tiles_x, tile_h):
    """Face lists of the CSR engine: each tile's CHUNK-aligned run."""
    strips = tile_h // BLOCK_H
    return FaceLists(
        ids=bins.entry_face,
        base=_per_block(bins.start_block * binning.CHUNK, tiles_y, tiles_x,
                        strips),
        count=_per_block(bins.counts, tiles_y, tiles_x, strips),
        groups=1, id_shift=0,
    )


def packed_lists(bins: binning.PackedBins, tiles_y, tiles_x, tile_h):
    """Face lists of the packed engine: one list per 8x16 subtile.

    Strip s of tile t owns iterations ``iter_off .. iter_off +
    strip_iters`` of the tile's run, truncated to the tile's effective
    iteration count under overflow; group g of iteration i is entry
    ``start_block * PACK_CHUNK + GROUPS * i + g``.
    """
    strips = tile_h // binning.SUB_H
    total = tiles_y * tiles_x
    off = bins.iter_off.reshape(total, strips)
    n = bins.strip_iters.reshape(total, strips)
    count = jnp.clip(
        jnp.minimum(n, bins.n_iters[:, None] - off), 0, None
    )
    base = (bins.start_block[:, None] * binning.PACK_CHUNK
            + binning.GROUPS * off)

    def per_block(v):
        return v.reshape(tiles_y, tiles_x, strips).transpose(0, 2, 1).reshape(
            tiles_y * strips, tiles_x
        ).astype(jnp.int32)

    return FaceLists(
        ids=bins.entries, base=per_block(base), count=per_block(count),
        groups=binning.GROUPS, id_shift=3,
    )


def pack_face_table(geo, att):
    """[F + 1, GEO_USED + 3C] plane rows with the sentinel face last.

    ``table[:F, :17]`` is geo's used columns, ``table[:F, 17:]`` is att.
    The sentinel row (face id F, every list's filler) has edge c0 = -1 with
    zero slopes, so it covers nothing, and a finite denominator.
    """
    table = jnp.concatenate([geo[:, :GEO_USED], att], axis=1)
    width = table.shape[1]
    sentinel = jnp.zeros((1, width), jnp.float32)
    sentinel = sentinel.at[0, 4].set(-1.0).at[0, 7].set(-1.0)
    sentinel = sentinel.at[0, 10].set(-1.0)
    sentinel = sentinel.at[0, 16].set(1.0)  # den c0 = 1: finite reciprocal
    return jnp.concatenate([table, sentinel], axis=0)


def _shade(cf, xg, yg, carry, face, channels):
    """One face over a block: z test, coverage, perspective-correct attrs.

    ``cf(k)`` returns plane coefficient k of the face (a scalar or a row
    that broadcasts over the block). Shared verbatim by the kernel and the
    plain twin so both round the same way.
    """
    zbuf, fid, pix = carry
    dx = xg - cf(0)    # anchored coordinates (see triangle_setup)
    dy = yg - cf(1)
    e0 = cf(2) * dx + cf(3) * dy + cf(4)
    e1 = cf(5) * dx + cf(6) * dy + cf(7)
    e2 = cf(8) * dx + cf(9) * dy + cf(10)
    inside = jnp.minimum(jnp.minimum(e0, e1), e2) >= 0.0
    zv = cf(11) * dx + cf(12) * dy + cf(13)
    mask = inside & (zv < zbuf) & (zv >= -1.0) & (zv <= 1.0)
    recip = 1.0 / (cf(14) * dx + cf(15) * dy + cf(16))
    pix = tuple(
        jnp.where(
            mask,
            (cf(GEO_USED + 3 * c) * dx + cf(GEO_USED + 3 * c + 1) * dy
             + cf(GEO_USED + 3 * c + 2)) * recip,
            pix[c],
        )
        for c in range(channels)
    )
    return jnp.where(mask, zv, zbuf), jnp.where(mask, face, fid), pix


def _scan_kernel(base_ref, count_ref, ids_ref, table_ref, bg_ref,
                 pix_ref, fid_ref, z_ref, *, channels, groups, id_shift,
                 block_h, block_w):
    i = pl.program_id(0)
    j = pl.program_id(1)
    base = base_ref[i, j]
    count = count_ref[i, j]
    row = jax.lax.broadcasted_iota(jnp.int32, (block_h, block_w), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (block_h, block_w), 1)
    xg = (j * block_w + col).astype(jnp.float32) + 0.5
    yg = (i * block_h + row).astype(jnp.float32) + 0.5
    grp = jax.lax.broadcasted_iota(jnp.int32, (block_w,), 0) // (
        block_w // groups
    )

    def body(k, carry):
        if groups == 1:
            # One list per block: the face id and its coefficients are
            # scalars broadcast over the block.
            face = ids_ref[base + k]
            if id_shift:
                face = face >> id_shift
            coef = lambda c: table_ref[face, c]
            return _shade(coef, xg, yg, carry, face, channels)
        face = ids_ref[base + k * groups + grp]          # [block_w]
        if id_shift:
            face = face >> id_shift
        coef = lambda c: table_ref[face, c][None, :]
        return _shade(coef, xg, yg, carry, face[None, :], channels)

    init = (
        jnp.full((block_h, block_w), BIG_Z, jnp.float32),
        jnp.full((block_h, block_w), -1, jnp.int32),
        tuple(bg_ref[c] for c in range(channels)),
    )
    zbuf, fid, pix = jax.lax.fori_loop(0, count, body, init)
    z_ref[...] = zbuf
    fid_ref[...] = fid
    for c in range(channels):
        pix_ref[c] = pix[c]


def _check_shapes(lists, table, background_chw):
    channels, hp, wp = background_chw.shape
    ni, nj = lists.base.shape
    if hp != ni * BLOCK_H or wp % nj:
        raise ValueError(
            f"image {hp}x{wp} does not split into {ni}x{nj} blocks of "
            f"{BLOCK_H} rows"
        )
    block_w = wp // nj
    if block_w & (block_w - 1) or block_w % lists.groups:
        raise ValueError(f"tile width {block_w} must be a power of two")
    if table.shape[1] != GEO_USED + 3 * channels:
        raise ValueError("face table width does not match the channels")
    return channels, hp, wp, ni, nj, block_w


def raster_forward(lists: FaceLists, table, background_chw):
    """Scan-convert every block's face list with the Triton kernel.

    Args:
        lists: per-block face lists (``dense_lists`` / ``csr_lists`` /
            ``packed_lists``).
        table: [F + 1, GEO_USED + 3C] f32 from :func:`pack_face_table`.
        background_chw: [C, Hp, Wp] f32, padded to tile multiples.
    Returns:
        pixels [C, Hp, Wp] f32, fid [Hp, Wp] int32, zbuf [Hp, Wp] f32.
    """
    channels, hp, wp, ni, nj, block_w = _check_shapes(
        lists, table, background_chw
    )
    kernel = functools.partial(
        _scan_kernel, channels=channels, groups=lists.groups,
        id_shift=lists.id_shift, block_h=BLOCK_H, block_w=block_w,
    )
    img3 = pl.BlockSpec((channels, BLOCK_H, block_w), lambda i, j: (0, i, j))
    img2 = pl.BlockSpec((BLOCK_H, block_w), lambda i, j: (i, j))
    return pl.pallas_call(
        kernel,
        grid=(ni, nj),
        in_specs=[
            pl.no_block_spec, pl.no_block_spec, pl.no_block_spec,
            pl.no_block_spec, img3,
        ],
        out_specs=(img3, img2, img2),
        out_shape=(
            jax.ShapeDtypeStruct((channels, hp, wp), jnp.float32),
            jax.ShapeDtypeStruct((hp, wp), jnp.int32),
            jax.ShapeDtypeStruct((hp, wp), jnp.float32),
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=cfg.use_interpret(),
        name="dirt_scan",
    )(lists.base, lists.count, lists.ids, table, background_chw)


def raster_forward_xla(lists: FaceLists, table, background_chw):
    """Plain-XLA twin of :func:`raster_forward` (same lists, same result).

    A ``fori_loop`` over list slots: step k evaluates slot k of every
    block's list(s) over all pixels at once, with the per-pixel state kept
    in image layout viewed as [blocks_y, BLOCK_H, blocks_x, groups,
    columns per group].
    """
    channels, hp, wp, ni, nj, block_w = _check_shapes(
        lists, table, background_chw
    )
    groups = lists.groups
    sub_w = block_w // groups
    shape5 = (ni, BLOCK_H, nj, groups, sub_w)
    yg = (jnp.arange(hp, dtype=jnp.float32) + 0.5).reshape(
        ni, BLOCK_H, 1, 1, 1
    )
    xg = (jnp.arange(wp, dtype=jnp.float32) + 0.5).reshape(
        1, 1, nj, groups, sub_w
    )
    sentinel = table.shape[0] - 1
    n_ids = lists.ids.shape[0]
    g_iota = jnp.arange(groups, dtype=jnp.int32)

    def body(k, carry):
        slot = lists.base[:, :, None] + k * groups + g_iota   # [ni, nj, G]
        face = lists.ids[jnp.minimum(slot, n_ids - 1)] >> lists.id_shift
        face = jnp.where((k < lists.count)[:, :, None], face, sentinel)
        rows = jnp.moveaxis(table[face], -1, 0)           # [W, ni, nj, G]
        coef = lambda c: rows[c][:, None, :, :, None]
        return _shade(coef, xg, yg, carry, face[:, None, :, :, None],
                      channels)

    init = (
        jnp.full(shape5, BIG_Z, jnp.float32),
        jnp.full(shape5, -1, jnp.int32),
        tuple(background_chw[c].reshape(shape5) for c in range(channels)),
    )
    zbuf, fid, pix = jax.lax.fori_loop(
        0, jnp.max(lists.count), body, init
    )
    return (
        jnp.stack(pix).reshape(channels, hp, wp),
        fid.reshape(hp, wp),
        zbuf.reshape(hp, wp),
    )
