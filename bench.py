"""Benchmark: fwd+bwd rasterization throughput on one NVIDIA GPU.

Prints ONE JSON line first: {"metric", "value", "unit", "device"} — the
Mpixels/s of one fwd+bwd step (render + weighted-sum loss + gradients
w.r.t. vertices, colours and background) on the ~10k-triangle UV sphere
at 1024^2 with honest caps (count-then-allocate; the overflow flag is
asserted clear), median of timed runs. Human-readable lines follow on
stderr: 256^2, the dense engine at 1024^2, the public clip-on path and the
~100k-triangle forward, each with the card's name and power limit.

Fails when JAX finds no GPU: a CPU number is not a measurement of this
system.
"""

import json
import subprocess
import sys

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from dirt_tpu.utils.compilecache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from dirt_tpu.core import matrices, mesh  # noqa: E402
from dirt_tpu.ops.raster import RasterConfig  # noqa: E402
from dirt_tpu.utils.benchtime import device_time_stats  # noqa: E402
import dirt_tpu  # noqa: E402


def card():
    """'name, power limit' of the card, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


@jax.jit
def _to_clip(verts_obj):
    mv = matrices.compose(
        matrices.rodrigues(jnp.array([0.4, 0.3, 0.0])),
        matrices.translation(jnp.array([0.0, 0.0, -3.0])),
    )
    proj = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    return matrices.transform_homogeneous(
        verts_obj, matrices.compose(mv, proj)
    )


def build(size, n=72):
    verts_obj, faces, _ = mesh.uv_sphere(n_lat=n, n_lon=n)
    clip = _to_clip(jnp.asarray(verts_obj))
    colors = jnp.asarray(
        np.random.RandomState(0).rand(len(verts_obj), 3), jnp.float32
    )
    bg = jnp.zeros((size, size, 3), jnp.float32)
    weights = jnp.asarray(
        np.random.RandomState(1).rand(size, size, 3), jnp.float32
    )
    return clip, colors, jnp.asarray(faces), bg, weights


def honest_config(clip_verts, colors, faces, size, base=None, clip=False):
    """Count-then-allocate caps that render the scene with no truncation."""
    config = dirt_tpu.suggest_raster_config(
        clip_verts, faces, size, size, config=base, clip=clip
    )
    _, _, _, overflow = dirt_tpu.rasterise_with_aux(
        jnp.zeros((size, size, 3), jnp.float32), clip_verts, colors, faces,
        config=config, clip=clip,
    )
    assert not bool(overflow), "bench scene must render untruncated"
    return config


def bench_size(size, engine=None, clip=False, n=72, backward=True):
    """(fwd+bwd or fwd) seconds per step: (min, median)."""
    clip_verts, colors, faces, bg, weights = build(size, n)
    base = RasterConfig(engine=engine) if engine else None
    config = honest_config(clip_verts, colors, faces, size, base, clip)

    # ``weights`` is an argument, not a closure capture, so XLA cannot
    # constant-fold the cotangent inside the timing loop.
    def fwd(c, co, b, w):
        return dirt_tpu.rasterise(b, c, co, faces, config=config, clip=clip)

    def loss(c, co, b, w):
        return jnp.sum(fwd(c, co, b, w) * w)

    fn = jax.grad(loss, argnums=(0, 1, 2)) if backward else fwd
    return device_time_stats(fn, (clip_verts, colors, bg, weights),
                             r2=12 if size >= 1024 else 42)


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {jax.devices()}")
    name = card()
    t_min, t_med = bench_size(1024)
    print(json.dumps({
        "metric": "Mpix/s fwd+bwd, 1024^2, 10k-tri sphere, 1 GPU",
        "value": round(1024 * 1024 / 1e6 / t_med, 2),
        "unit": "Mpix/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)

    def line(label, size, stats):
        lo, med = stats
        print(f"# {label}: {med * 1e3:.3f} ms median (min "
              f"{lo * 1e3:.3f}), {size * size / 1e6 / med:.1f} Mpix/s "
              f"[{name}]", file=sys.stderr, flush=True)

    line("1024^2 fwd+bwd", 1024, (t_min, t_med))
    line("256^2 fwd+bwd", 256, bench_size(256))
    line("1024^2 fwd+bwd, dense engine", 1024,
         bench_size(1024, engine="dense"))
    line("1024^2 fwd+bwd, clip on (public default)", 1024,
         bench_size(1024, clip=True))
    line("1024^2 fwd, ~100k-tri sphere", 1024,
         bench_size(1024, n=224, backward=False))


if __name__ == "__main__":
    main()
