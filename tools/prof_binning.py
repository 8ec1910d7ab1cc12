"""Micro-profile of bin_faces_packed's primitive costs.

Times each primitive of the packed binning pipeline at the flagship
1024^2 / 10k-tri honest-caps sizes (pool ~99k slots, merged sort ~108k
elements, budget ~151k rows), so work on the binning is aimed at measured
costs. Also A/Bs candidate layouts (multi-array lexicographic sort vs a
single packed key).

Run: python tools/prof_binning.py [size]
"""

import sys

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from dirt_tpu.utils.compilecache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from dirt_tpu.ops import binning  # noqa: E402
from dirt_tpu.ops.raster import suggest_config  # noqa: E402
from dirt_tpu.ops.triangle_setup import (  # noqa: E402
    edge_filter_cols,
    face_bbox_cols,
    screen_from_clip,
    setup_planes,
)
from dirt_tpu.utils.benchtime import device_time  # noqa: E402


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    from bench import build

    clip, colors, faces, bg, weights = build(size)
    fv, fa = jax.jit(
        lambda cv, co, f: (screen_from_clip(cv, size, size)[f], co[f])
    )(clip, colors, faces)
    config = suggest_config(fv, size, size).concrete(size)
    print(f"# config: {config}", file=sys.stderr)
    tile_h, tile_w = config.tile_h, config.tile_w
    hp = -(-size // tile_h) * tile_h
    wp = -(-size // tile_w) * tile_w
    _, _, strips, groups = binning.packed_grid(hp, wp, tile_h, tile_w)
    tiles_y, tiles_x = hp // tile_h, wp // tile_w
    nsid = tiles_y * tiles_x * strips * groups

    def staged(stage):
        def fn(fv, fa):
            geo, att, valid = setup_planes(fv, fa)
            bbox = face_bbox_cols(fv, valid, size, size)
            edges = edge_filter_cols(fv)
            return binning.bin_faces_packed(
                bbox, hp, wp, tile_h, tile_w, config.budget,
                config.expand_cap, edges=edges, pool_cap=config.pool_cap,
                work_cap=config.work_cap, _stage=stage,
            )
        return fn

    t_full = device_time(staged(0), (fv, fa))
    print(f"full setup+binning      {t_full*1e3:7.3f} ms")

    # Cumulative stage timings (fv is the perturbed float arg, so the
    # workload cannot CSE-collapse; _stage returns a checksum scalar).
    names = [
        (11, "1a pool face_of/s0_of"), (12, "1b pool ey/ex div + frow"),
        (13, "1c pool edge filter"), (1, "1 pool construction"),
        (2, "2 merged sort + rank"), (3, "3 subtile counts"),
        (4, "4 grid prefix math"), (5, "5 pair placement"),
        (6, "6 entries scatter"),
        (7, "7 entries scatter"),
    ]
    prev = 0.0
    for stage, name in names:
        t = device_time(staged(stage), (fv, fa), r2=24)
        print(f"  thru {name:29s} {t*1e3:7.3f} ms (+{(t-prev)*1e3:6.3f})")
        prev = t

    pool_cap = config.pool_cap
    budget_rows = config.budget * binning.GROUPS
    n_merged = pool_cap + nsid
    rng = np.random.RandomState(0)
    print(f"# pool={pool_cap} nsid={nsid} merged={n_merged} "
          f"rows={budget_rows}")

    sid = jnp.asarray(rng.randint(0, nsid + 1, n_merged), jnp.int32)
    face = jnp.asarray(rng.randint(-1, 10224, n_merged), jnp.int32)
    q = jnp.asarray(rng.permutation(n_merged), jnp.int32)
    key = (sid << 17) | (q & 0x1FFFF)

    t = device_time(
        lambda s, f, qq: jax.lax.sort((s, f, qq), num_keys=2),
        (sid, face, q), r2=32,
    )
    print(f"sort1 (3 arrays, 2 keys)  {t*1e3:7.3f} ms")
    t = device_time(
        lambda k, f: jax.lax.sort((k, f), num_keys=1), (key, face), r2=32
    )
    print(f"sort1p (2 arrays, 1 key)  {t*1e3:7.3f} ms")
    t = device_time(
        lambda k: jax.lax.sort((k,), num_keys=1)[0], (key,), r2=32
    )
    print(f"sort (1 array, 1 key)     {t*1e3:7.3f} ms")
    t = device_time(
        lambda s, f: jax.lax.sort((s, f), num_keys=1), (sid, face), r2=32
    )
    print(f"sort2/3 (2 arrays, 1 key) {t*1e3:7.3f} ms")

    # Row gathers at binning sizes.
    ftbl = jnp.asarray(rng.rand(10232, 16), jnp.float32)
    pidx = jnp.asarray(rng.randint(0, 10232, pool_cap), jnp.int32)
    t = device_time(lambda tb, i: tb[i], (ftbl, pidx), r2=32)
    print(f"pool ftbl gather [pool,16] {t*1e3:7.3f} ms")

    face_w = jnp.broadcast_to(face[:, None], (n_merged, 8))
    src = jnp.asarray(rng.randint(0, n_merged, budget_rows), jnp.int32)
    t = device_time(
        lambda fw, s: fw[s][:, 0], (face_w, src), r2=32
    )
    print(f"entries gather [rows]      {t*1e3:7.3f} ms")
    t = device_time(
        lambda f, s: jnp.broadcast_to(f[:, None], (n_merged, 8))[s][:, 0],
        (face, src), r2=32,
    )
    print(f"entries bcast+gather       {t*1e3:7.3f} ms")

    # Scans / cummax at pool and merged sizes.
    t = device_time(
        lambda x: jax.lax.cummax(x), (q,), r2=32
    )
    print(f"cummax [merged]            {t*1e3:7.3f} ms")
    pool_i = jnp.asarray(rng.randint(0, 100, pool_cap), jnp.int32)
    t = device_time(
        lambda x: jax.lax.associative_scan(jnp.maximum, x), (pool_i,),
        r2=32,
    )
    print(f"assoc_scan max [pool]      {t*1e3:7.3f} ms")

    # Scatters at candidate counts (float first arg defeats the int-
    # workload collapse in device_time's perturbation).
    fz = jnp.zeros((8,), jnp.float32)
    upd = jnp.asarray(rng.randint(0, nsid, pool_cap), jnp.int32)
    t = device_time(
        lambda z, u: jnp.zeros((nsid + 1,), jnp.int32).at[
            u + z[0].astype(jnp.int32)].add(1, mode="drop"),
        (fz, upd), r2=32,
    )
    print(f"scatter-add pool->nsid     {t*1e3:7.3f} ms")
    slot0 = jnp.asarray(
        np.sort(rng.choice(pool_cap, 10224, replace=False)), jnp.int32
    )
    fidx = jnp.arange(10224, dtype=jnp.int32)
    t = device_time(
        lambda z, s, f: jnp.full((pool_cap,), -1, jnp.int32).at[
            s + z[0].astype(jnp.int32)].set(f, mode="drop"),
        (fz, slot0, fidx), r2=32,
    )
    print(f"scatter-set F->pool        {t*1e3:7.3f} ms")
    t = device_time(
        lambda z, u: jax.lax.cummax(u + z[0].astype(jnp.int32)),
        (fz, q), r2=32,
    )
    print(f"cummax [merged] (fixed)    {t*1e3:7.3f} ms")
    t = device_time(
        lambda z, u: jax.lax.cummax(u + z[0].astype(jnp.int32)),
        (fz, pidx), r2=32,
    )
    print(f"cummax [pool] (fixed)      {t*1e3:7.3f} ms")


if __name__ == "__main__":
    main()
