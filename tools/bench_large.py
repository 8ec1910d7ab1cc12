"""Large-mesh benchmark: 100k / 1M triangles at honest caps.

Measures the auto-resolved engine with count-then-allocate caps: fwd AND
fwd+bwd, overflow-asserted complete renders, on the GPU.

Run: python tools/bench_large.py [n_lat ...]   (default 224 708)
"""

import sys

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from dirt_tpu.utils.compilecache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import dirt_tpu  # noqa: E402
from dirt_tpu.core import mesh  # noqa: E402
from dirt_tpu.utils.benchtime import device_time  # noqa: E402


def run(n_lat, size=1024):
    from bench import _to_clip, honest_config

    verts_obj, faces, _ = mesh.uv_sphere(n_lat=n_lat, n_lon=n_lat)
    clip = _to_clip(jnp.asarray(verts_obj))
    colors = jnp.asarray(
        np.random.RandomState(0).rand(len(verts_obj), 3), jnp.float32
    )
    faces = jnp.asarray(faces)
    bg = jnp.zeros((size, size, 3), jnp.float32)
    weights = jnp.asarray(
        np.random.RandomState(1).rand(size, size, 3), jnp.float32
    )
    nf = faces.shape[0]
    config = honest_config(clip, colors, faces, size)
    print(f"# {nf} faces: {config}", file=sys.stderr)

    def fwd(c, co, b, w):
        return dirt_tpu.rasterise(
            b, c, co, faces, config=config, clip=False
        )

    def loss(c, co, b, w):
        img = dirt_tpu.rasterise(
            b, c, co, faces, config=config, clip=False
        )
        return jnp.sum(img * w)

    args = (clip, colors, bg, weights)
    t_f = device_time(fwd, args, r1=2, r2=8, samples=3)
    t_b = device_time(
        jax.grad(loss, argnums=(0, 1, 2)), args, r1=2, r2=6, samples=3
    )
    mpix = size * size / 1e6
    print(
        f"{nf:8d} tris {size}^2: fwd {t_f*1e3:8.2f} ms "
        f"({mpix/t_f:6.1f} Mpix/s)   fwd+bwd {t_b*1e3:8.2f} ms "
        f"({mpix/t_b:6.1f} Mpix/s)"
    )


def main():
    lats = [int(a) for a in sys.argv[1:]] or [224, 708]
    for n_lat in lats:
        run(n_lat)


if __name__ == "__main__":
    main()
