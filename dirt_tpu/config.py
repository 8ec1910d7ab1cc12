"""Global configuration for dirt_tpu.

The Pallas kernels compile for NVIDIA GPUs through Pallas's Triton route;
on the CPU (tests, CI) they run under the Pallas interpreter. No other
backend falls back to the interpreter: a kernel that cannot compile for
the device it runs on is an error.
"""

from __future__ import annotations

import jax


def use_interpret() -> bool:
    """Whether pallas_call should run in interpreter mode (CPU only)."""
    return jax.default_backend() == "cpu"


# Default image-space tile size for binning. Kernel programs cover
# BLOCK_H-row strips of a tile's full width (``ops.raster_fwd``), and
# Triton blocks must be powers of two, so the width is a power of two;
# 128 columns is also the packed engine's 8 groups of 16-column subtiles.
# Tile heights are multiples of the 8-row strip.
TILE_H = 32
TILE_W = 128

# Default cap on the number of triangles binned to a single tile. Binned
# face lists are static-shape [num_tiles, bin_cap]; overflow is reported via
# the `overflow` field of the binning result (never silently truncated
# without a flag).
DEFAULT_BIN_CAP = 1024
