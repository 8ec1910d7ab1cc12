"""Packed-subtile binning: layout invariants vs brute force."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dirt_tpu.ops import binning
from dirt_tpu.ops.binning import (
    PACK_CHUNK,
    GROUPS,
    PACK_ITERS,
    SUB_H,
    SUB_W,
    packed_grid,
)

# Jitted: eager op-by-op execution compiles every tiny op separately.
bin_faces_packed = jax.jit(
    binning.bin_faces_packed,
    static_argnums=(1, 2, 3, 4, 5, 6),
    static_argnames=("pool_cap", "work_cap", "_stage"),
)


def _brute_jobs(bbox, height, width, tile_h, tile_w):
    """subtile (t, s, g) -> ascending face list, by brute force."""
    tiles_y, tiles_x, strips, groups = packed_grid(
        height, width, tile_h, tile_w
    )
    jobs = {}
    for f, (xmin, xmax, ymin, ymax) in enumerate(bbox):
        if xmax < xmin or ymax < ymin:
            continue
        for gy in range(ymin // SUB_H, ymax // SUB_H + 1):
            for gx in range(xmin // SUB_W, xmax // SUB_W + 1):
                t = (gy // strips) * tiles_x + gx // groups
                key = (t, gy % strips, gx % groups)
                jobs.setdefault(key, []).append(f)
    return jobs


def _decode(pb, nf, total, strips):
    """entries -> dict (t, s, g) -> face list, via the kernel's addressing."""
    entries = np.asarray(pb.entries)
    start_block = np.asarray(pb.start_block)
    n_iters = np.asarray(pb.n_iters)
    out = {}
    for t in range(total):
        base = start_block[t] * PACK_CHUNK
        # Walk iterations; strip comes from the group-0 entry (the
        # kernel's own addressing rule).
        for it in range(n_iters[t]):
            row0 = base + it * GROUPS
            s = entries[row0] % 8
            for g in range(GROUPS):
                v = entries[row0 + g]
                assert v % 8 == s, "strip must be uniform per iteration"
                face = v // 8
                if face < nf:
                    out.setdefault((t, int(s), g), []).append(int(face))
    return out


def _run_case(bbox, height, width, tile_h=32, tile_w=128, budget=None,
              expand=64):
    bbox = np.asarray(bbox, np.int32)
    nf = len(bbox)
    tiles_y, tiles_x, strips, groups = packed_grid(
        height, width, tile_h, tile_w
    )
    total = tiles_y * tiles_x
    if budget is None:
        budget = binning.auto_packed_budget(
            nf, height, width, tile_h, tile_w
        )
    pb = bin_faces_packed(
        jnp.asarray(bbox), height, width, tile_h, tile_w, budget, expand
    )
    return pb, nf, total, strips


@pytest.mark.slow
def test_packed_matches_brute_force_random():
    rng = np.random.RandomState(0)
    height, width = 64, 256
    boxes = []
    for _ in range(200):
        x0 = rng.randint(0, width)
        y0 = rng.randint(0, height)
        boxes.append([x0, min(x0 + rng.randint(0, 40), width - 1),
                      y0, min(y0 + rng.randint(0, 30), height - 1)])
    boxes.append([0, -1, 0, -1])  # empty box: no jobs
    pb, nf, total, strips = _run_case(boxes, height, width)
    assert not bool(pb.overflow)
    got = _decode(pb, nf, total, strips)
    want = _brute_jobs(np.asarray(boxes, np.int32), height, width, 32, 128)
    assert got == want


@pytest.mark.slow
def test_packed_chunk_map_and_alignment():
    rng = np.random.RandomState(1)
    height, width = 64, 128
    boxes = [[rng.randint(0, 100), 120, rng.randint(0, 50), 60]
             for _ in range(30)]
    pb, nf, total, strips = _run_case(boxes, height, width)
    start_block = np.asarray(pb.start_block)
    n_iters = np.asarray(pb.n_iters)
    budget_chunks = pb.entries.shape[0] // binning.PACK_CHUNK
    # Tiles start at ascending chunk offsets, and each tile's chunks (at
    # least one) end before the next tile's start.
    assert (np.diff(start_block) >= 1).all()
    ends = np.append(start_block[1:], budget_chunks)
    for t in range(total):
        need = max(1, -(-int(n_iters[t]) // PACK_ITERS))
        assert start_block[t] + need <= ends[t]


@pytest.mark.slow
def test_packed_budget_overflow_flagged():
    # 200 faces piled on one subtile -> 200 iterations needed; a budget of
    # 2 chunks (128 iters) cannot hold them -> flagged, every tile still
    # keeps an init chunk.
    boxes = [[0, 7, 0, 7]] * 200
    pb, nf, total, strips = _run_case(
        boxes, 32, 128, tile_h=32,
        budget=2 * PACK_ITERS * 1, expand=4,
    )
    assert total == 1
    # budget floor assertion requires >= total chunks; 2 chunks here.
    assert bool(pb.overflow)
    assert np.asarray(pb.n_iters)[0] <= 2 * PACK_ITERS


def test_work_cap_exact_when_sized_to_live_content():
    """A work_cap covering headers + real jobs reproduces the unsliced
    binning bit-for-bit, and an undersized cap flags."""
    rng = np.random.RandomState(11)
    height, width = 64, 256
    boxes = []
    for _ in range(120):
        x0 = rng.randint(0, width)
        y0 = rng.randint(0, height)
        boxes.append([x0, min(x0 + rng.randint(0, 40), width - 1),
                      y0, min(y0 + rng.randint(0, 30), height - 1)])
    boxes.append([0, -1, 0, -1])
    bbox = np.asarray(boxes, np.int32)
    tile_h, tile_w = 32, 128
    tiles_y, tiles_x, strips, groups = packed_grid(
        height, width, tile_h, tile_w
    )
    nsid = tiles_y * tiles_x * strips * groups
    budget, expand = 2048, 64

    ref = bin_faces_packed(
        jnp.asarray(bbox), height, width, tile_h, tile_w, budget, expand
    )
    assert not bool(ref.overflow)
    n_jobs = sum(
        len(v) for v in _brute_jobs(bbox, height, width, tile_h, tile_w)
        .values()
    )

    capped = bin_faces_packed(
        jnp.asarray(bbox), height, width, tile_h, tile_w, budget, expand,
        work_cap=nsid + n_jobs,
    )
    assert not bool(capped.overflow)
    np.testing.assert_array_equal(
        np.asarray(capped.entries), np.asarray(ref.entries))
    np.testing.assert_array_equal(
        np.asarray(capped.n_iters), np.asarray(ref.n_iters))

    # Undersized: jobs were cut -> flagged, and the cut is CLEAN (every
    # placed entry is a real (face, strip) job of the full run).
    small = bin_faces_packed(
        jnp.asarray(bbox), height, width, tile_h, tile_w, budget, expand,
        work_cap=nsid + n_jobs // 2,
    )
    assert bool(small.overflow)
    got = _decode(small, len(boxes), tiles_y * tiles_x, strips)
    want = _brute_jobs(bbox, height, width, tile_h, tile_w)
    for key, faces_list in got.items():
        assert set(faces_list) <= set(want.get(key, [])), key


def test_suggest_work_cap_silences_and_matches():
    """suggest_config's work_cap must not flag, and the work-capped
    binning must equal the uncapped one on the same filtered scene."""
    from dirt_tpu.ops.raster import count_packed_exact
    from dirt_tpu.ops.triangle_setup import (
        edge_filter_cols, face_bbox_cols, setup_planes,
    )

    rng = np.random.RandomState(13)
    height, width = 64, 256
    nf = 50
    fv = np.zeros((nf, 3, 4), np.float32)
    fv[..., 0] = rng.uniform(-20, width + 20, (nf, 3))
    fv[..., 1] = rng.uniform(-20, height + 20, (nf, 3))
    fv[..., 3] = 1.0
    fv = jnp.asarray(fv)
    _, _, valid = setup_planes(fv, jnp.zeros((nf, 3, 1), jnp.float32))
    bbox = face_bbox_cols(fv, valid, height, width)
    edges = edge_filter_cols(fv)
    tile_h, tile_w = 32, 128
    exp, bud, pool, work = count_packed_exact(
        jnp.stack(bbox, axis=1), height, width, tile_h, tile_w,
        margin=1.0, face_verts_screen=fv)
    ref = bin_faces_packed(bbox, height, width, tile_h, tile_w, bud, exp,
                           edges=edges, pool_cap=pool)
    capped = bin_faces_packed(bbox, height, width, tile_h, tile_w, bud,
                              exp, edges=edges, pool_cap=pool,
                              work_cap=work)
    assert not bool(capped.overflow)
    np.testing.assert_array_equal(
        np.asarray(capped.entries), np.asarray(ref.entries))


def test_packed_expand_cap_overflow_flagged():
    # One face spanning more subtiles than expand_cap.
    boxes = [[0, 127, 0, 31]]
    pb, *_ = _run_case(boxes, 32, 128, expand=4)
    assert bool(pb.overflow)


def test_packed_rank_order_is_face_ascending():
    # All faces on the same subtile: ranks must be ascending face ids
    # (the dense path's deterministic z-tie rule).
    boxes = [[0, 7, 0, 7]] * 5
    pb, nf, total, strips = _run_case(boxes, 32, 128)
    got = _decode(pb, nf, total, strips)
    assert got[(0, 0, 0)] == [0, 1, 2, 3, 4]


def test_count_packed_exact_silences_overflow():
    """suggest_config's packed counting (count_packed_exact) must produce
    caps under which bin_faces_packed never flags, even for scenes the
    auto heuristics truncate (big faces spanning many subtiles)."""
    from dirt_tpu.ops.raster import count_packed_exact

    rng = np.random.RandomState(5)
    height, width = 128, 256
    boxes = []
    for _ in range(120):   # small faces
        x0 = rng.randint(0, width)
        y0 = rng.randint(0, height)
        boxes.append([x0, min(x0 + rng.randint(0, 20), width - 1),
                      y0, min(y0 + rng.randint(0, 14), height - 1)])
    for _ in range(10):    # big faces: span dozens of subtiles
        boxes.append([4, width - 5, 8, height - 9])
    bbox = np.asarray(boxes, np.int32)
    tile_h, tile_w = 32, 128

    # Auto caps flag on this scene (that's the scenario under test).
    auto_expand = binning.auto_packed_expand(len(boxes), 1)
    exp, bud, pool, work = count_packed_exact(
        jnp.asarray(bbox), height, width, tile_h, tile_w)
    assert exp > auto_expand
    cols = tuple(jnp.asarray(bbox[:, k]) for k in range(4))
    pb = bin_faces_packed(cols, height, width, tile_h, tile_w, bud, exp,
                          pool_cap=pool, work_cap=work)
    assert not bool(pb.overflow)

    # And the binning is complete: every brute-force job is present.
    tiles_y, tiles_x, strips, groups = packed_grid(
        height, width, tile_h, tile_w)
    got = _decode(pb, len(boxes), tiles_y * tiles_x, strips)
    want = _brute_jobs(bbox, height, width, tile_h, tile_w)
    assert got == want


def test_edge_filter_never_drops_visible_subtiles():
    """The exact triangle-vs-subtile filter may only drop candidates
    whose subtile the triangle cannot touch: every subtile containing a
    brute-force-covered pixel center must stay binned."""
    from dirt_tpu.ops.triangle_setup import (
        edge_filter_cols, face_bbox_cols, setup_planes,
    )

    rng = np.random.RandomState(9)
    height, width = 64, 256
    nf = 40
    fv = np.zeros((nf, 3, 4), np.float32)
    fv[..., 0] = rng.uniform(-10, width + 10, (nf, 3))
    fv[..., 1] = rng.uniform(-10, height + 10, (nf, 3))
    fv[..., 2] = rng.uniform(-0.5, 0.5, (nf, 3))
    fv[..., 3] = 1.0  # invw
    fv = jnp.asarray(fv)
    attrs = jnp.zeros((nf, 3, 1), jnp.float32)
    geo, att, valid = setup_planes(fv, attrs)
    bbox = face_bbox_cols(fv, valid, height, width)
    edges = edge_filter_cols(fv)
    tile_h, tile_w = 32, 128
    # Faces span up to the whole 16x8-subtile grid: explicit generous
    # caps so neither run flags (the filter is what is under test).
    budget, expand = 4096, 160
    pb_f = bin_faces_packed(bbox, height, width, tile_h, tile_w,
                            budget, expand, edges=edges)
    pb_n = bin_faces_packed(bbox, height, width, tile_h, tile_w,
                            budget, expand)
    assert not bool(pb_f.overflow) and not bool(pb_n.overflow)
    tiles_y, tiles_x, strips, groups = packed_grid(
        height, width, tile_h, tile_w)
    got_f = _decode(pb_f, nf, tiles_y * tiles_x, strips)
    got_n = _decode(pb_n, nf, tiles_y * tiles_x, strips)
    # Filtered jobs are a subset of bbox jobs.
    for key, faces_list in got_f.items():
        assert set(faces_list) <= set(got_n.get(key, []))
    # Brute-force pixel coverage: edge functions at pixel centers.
    geo_np = np.asarray(geo)
    x0, y0 = geo_np[:, 0], geo_np[:, 1]
    xs = np.arange(width) + 0.5
    ys = np.arange(height) + 0.5
    dx = xs[None, None, :] - x0[:, None, None]
    dy = ys[None, :, None] - y0[:, None, None]
    covered_any = np.zeros((nf, height, width), bool)
    for f in range(nf):
        e_ok = np.ones((height, width), bool)
        for k in range(3):
            a, b, c = geo_np[f, 2 + 3 * k:5 + 3 * k]
            e_ok &= (a * dx[f] + b * dy[f] + c) >= 0
        covered_any[f] = e_ok
    missing = []
    for f in range(nf):
        ys_c, xs_c = np.nonzero(covered_any[f])
        for y, x in zip(ys_c, xs_c):
            gy, gx = y // 8, x // 16
            t = (gy // strips) * tiles_x + gx // groups
            key = (t, gy % strips, gx % groups)
            if f not in got_f.get(key, []):
                missing.append((f, y, x))
    assert not missing, missing[:10]


def test_filtered_count_matches_filtered_binning():
    """count_packed_exact(face_verts_screen=...) budgets must silence the
    overflow flag of an edge-FILTERED bin_faces_packed run."""
    from dirt_tpu.ops.raster import count_packed_exact
    from dirt_tpu.ops.triangle_setup import (
        edge_filter_cols, face_bbox_cols, setup_planes,
    )

    rng = np.random.RandomState(3)
    height, width = 64, 256
    nf = 60
    fv = np.zeros((nf, 3, 4), np.float32)
    fv[..., 0] = rng.uniform(-20, width + 20, (nf, 3))
    fv[..., 1] = rng.uniform(-20, height + 20, (nf, 3))
    fv[..., 3] = 1.0
    fv = jnp.asarray(fv)
    _, _, valid = setup_planes(fv, jnp.zeros((nf, 3, 1), jnp.float32))
    bbox = face_bbox_cols(fv, valid, height, width)
    bbox4 = jnp.stack(bbox, axis=1)
    tile_h, tile_w = 32, 128
    exp, bud, pool, work = count_packed_exact(
        bbox4, height, width, tile_h, tile_w, margin=1.0,
        face_verts_screen=fv)
    edges = edge_filter_cols(fv)
    pb = bin_faces_packed(bbox, height, width, tile_h, tile_w, bud, exp,
                          edges=edges, pool_cap=pool, work_cap=work)
    assert not bool(pb.overflow)
