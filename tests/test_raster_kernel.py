"""The scan kernel (Pallas, Triton route) vs its plain-XLA twin and the oracle.

On the CPU the kernel runs in Pallas interpret mode; the ``gpu`` test
compiles it for the card and skips where there is none (chip_smoke.py runs
the same comparison at real size).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dirt_tpu import config as cfg
from dirt_tpu.ops import raster
from dirt_tpu.ops.raster import RasterConfig
from dirt_tpu.ops.raster_fwd import (
    BLOCK_H,
    raster_forward,
    raster_forward_xla,
)
from dirt_tpu.ref import slowref


def _soup(seed, num_faces, height, width, channels, z_ties=False):
    """Random screen-space triangles, perspective-varying 1/w."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(
        [4, 4], [width - 4, height - 4], (num_faces, 1, 2))
    xy = centers + rng.uniform(-18, 18, (num_faces, 3, 2))
    if z_ties:
        # Constant-depth faces, each repeated later in the list with other
        # colours: on the exact z ties the first copy (lower id) must win.
        z = np.repeat(rng.uniform(-0.9, 0.9, (num_faces, 1)), 3, axis=1)
    else:
        z = rng.uniform(-0.9, 0.9, (num_faces, 1)) + rng.uniform(
            -0.05, 0.05, (num_faces, 3))
    invw = rng.uniform(0.5, 1.5, (num_faces, 3))
    fv = np.concatenate([xy, z[..., None], invw[..., None]], -1)
    if z_ties:
        fv = np.concatenate([fv, fv])
    fa = rng.rand(fv.shape[0], 3, channels)
    bg = rng.rand(height, width, channels)
    return (fv.astype(np.float32), fa.astype(np.float32),
            bg.astype(np.float32))


def _config(engine):
    # tile_h = 16 gives two kernel programs (BLOCK_H rows each) per tile;
    # packed caps are explicit because the soups' large triangles are far
    # from the dense-mesh statistics the auto caps assume.
    if engine == "packed":
        return RasterConfig(tile_h=16, engine=engine, expand_cap=64,
                            budget=4096)
    if engine == "csr":
        return RasterConfig(tile_h=16, engine=engine, expand_cap=64)
    return RasterConfig(tile_h=16, engine=engine)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _forward(fv, fa, bg, config, scan):
    return raster._forward_impl(fv, fa, bg, config, scan=scan)


def _assert_close_to_oracle(pix, fid, ref_pix, ref_fid):
    # float64 oracle vs f32 planes: a pixel centre within f32 rounding of
    # an edge may fall either way; the image must agree everywhere else.
    mismatch = fid != ref_fid
    assert mismatch.mean() < 0.002, f"coverage mismatch {mismatch.mean():.4f}"
    agree = ~mismatch
    np.testing.assert_allclose(pix[agree], ref_pix[agree], atol=1e-4)


CASES = [
    # (engine, channels, height, width)
    ("dense", 1, 40, 200),
    ("dense", 3, 48, 128),
    ("dense", 6, 33, 130),
    ("csr", 1, 48, 128),
    ("csr", 3, 40, 200),
    ("csr", 6, 56, 96),
    ("packed", 1, 56, 96),
    ("packed", 3, 33, 130),
    ("packed", 6, 40, 200),
]


@pytest.mark.parametrize("engine,channels,height,width", CASES)
def test_scan_kernel_matches_plain_and_oracle(engine, channels, height,
                                               width):
    fv, fa, bg = _soup(channels + height, 40, height, width, channels)
    config = _config(engine)
    assert raster.resolve_engine(config.concrete(height), 40) == engine
    pix_k, fid_k, z_k, ovf = _forward(fv, fa, bg, config, raster_forward)
    pix_x, fid_x, z_x, _ = _forward(fv, fa, bg, config, raster_forward_xla)
    assert not bool(jnp.any(ovf))
    # Kernel (interpreted) and twin evaluate the same ops on the CPU.
    np.testing.assert_array_equal(np.asarray(fid_k), np.asarray(fid_x))
    np.testing.assert_allclose(np.asarray(pix_k), np.asarray(pix_x),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(z_k), np.asarray(z_x), atol=1e-6)
    ref_pix, ref_fid, _ = slowref.oracle_forward(fv, fa, bg)
    _assert_close_to_oracle(np.asarray(pix_k), np.asarray(fid_k),
                            ref_pix, ref_fid)


@pytest.mark.parametrize("engine", ["dense", "csr", "packed"])
def test_scan_kernel_z_ties_lowest_face_wins(engine):
    fv, fa, bg = _soup(5, 8, 48, 128, 3, z_ties=True)
    pix_k, fid_k, _, _ = _forward(fv, fa, bg, _config(engine),
                                  raster_forward)
    ref_pix, ref_fid, _ = slowref.oracle_forward(fv, fa, bg)
    fid_k = np.asarray(fid_k)
    _assert_close_to_oracle(np.asarray(pix_k), fid_k, ref_pix, ref_fid)
    # No repeated copy (ids 8..15) wins a pixel from its original.
    assert (fid_k >= 0).sum() > 300
    assert fid_k.max() < 8


@pytest.mark.parametrize("tile_w", [96, 130])
def test_scan_rejects_non_power_of_two_tiles(tile_w):
    fv, fa, bg = _soup(1, 4, 32, 256, 1)
    config = RasterConfig(tile_h=16, tile_w=tile_w, engine="dense")
    with pytest.raises(ValueError, match="power of two"):
        _forward(fv, fa, bg, config, raster_forward)


def test_scan_block_grid_follows_tiles():
    """One program per BLOCK_H-row strip of every tile, padded image."""
    fv, fa, bg = _soup(2, 10, 40, 200, 2)
    lists, table, bg_chw, _ = raster._scan_inputs(
        jnp.asarray(fv), jnp.asarray(fa), jnp.asarray(bg), _config("dense"))
    assert bg_chw.shape == (2, 48, 256)        # padded to 16 x 128 tiles
    assert lists.base.shape == (48 // BLOCK_H, 2)
    assert table.shape == (11, 17 + 3 * 2)     # sentinel row last
    # Both strips of a tile walk that tile's list.
    np.testing.assert_array_equal(lists.base[0], lists.base[1])
    np.testing.assert_array_equal(lists.count[0], lists.count[1])


@pytest.mark.parametrize("backend,expected", [("cpu", True), ("gpu", False)])
def test_use_interpret_only_on_cpu(monkeypatch, backend, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert cfg.use_interpret() is expected


@pytest.mark.gpu
def test_scan_kernel_compiles_and_matches_plain_on_gpu(gpu):
    """Compiled (not interpreted) kernel vs the twin on the card."""
    assert not cfg.use_interpret()
    with jax.default_device(gpu):
        for engine in ("dense", "csr", "packed"):
            fv, fa, bg = _soup(3, 300, 256, 256, 3)
            config = _config(engine)
            pix_k, fid_k, _, _ = _forward(fv, fa, bg, config,
                                          raster_forward)
            pix_x, fid_x, _, _ = _forward(fv, fa, bg, config,
                                          raster_forward_xla)
            fid_k, fid_x = np.asarray(fid_k), np.asarray(fid_x)
            # FMA contraction differs between Triton and XLA: edge pixels.
            assert (fid_k != fid_x).mean() <= 0.002
            agree = fid_k == fid_x
            np.testing.assert_allclose(np.asarray(pix_k)[agree],
                                       np.asarray(pix_x)[agree],
                                       atol=1e-5, rtol=1e-5)
