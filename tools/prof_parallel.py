"""One-card overhead of the parallel paths.

The sharded/overlapped/face-sharded renderers are exactness-proven on the
virtual 8-device mesh (tests/test_sharding.py, test_overlap.py,
test_face_sharding.py); their one-card TAX vs the plain path is measurable
on one card: a 1-device mesh runs the full code path (shard_map, trivial
ppermutes/psums, band backward) minus actual communication.

Measures, on the flagship 1024^2 / 10k-tri honest-caps scene:
  plain          jax.grad over dirt_tpu.rasterise (the bench step)
  sharded n=1    rasterise_sharded over a 1-device "tiles" mesh
  overlap k      rasterise_sharded(overlap_chunks=k), k in {1, 2, 4}
  face n=1       rasterise_face_sharded over a 1-device "faces" mesh

Run: python tools/prof_parallel.py [size]
"""

import sys

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from dirt_tpu.utils.compilecache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import dirt_tpu  # noqa: E402
from dirt_tpu.parallel.face_sharding import rasterise_face_sharded  # noqa: E402
from dirt_tpu.parallel.sharding import rasterise_sharded  # noqa: E402
from dirt_tpu.utils.benchtime import device_time  # noqa: E402


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    from bench import build, honest_config

    clip, colors, faces, bg, weights = build(size)
    config = honest_config(clip, colors, faces, size)
    print(f"# config: {config}", file=sys.stderr)
    mesh_t = Mesh(np.array(jax.devices()[:1]), ("tiles",))
    mesh_f = Mesh(np.array(jax.devices()[:1]), ("faces",))

    def t_of(loss):
        return device_time(
            jax.grad(loss, argnums=(0, 1, 2)), (clip, colors, bg, weights)
        )

    def plain(c, co, b, w):
        img = dirt_tpu.rasterise(b, c, co, faces, config=config, clip=False)
        return jnp.sum(img * w)

    t_plain = t_of(plain)
    print(f"plain             {t_plain*1e3:7.3f} ms")

    def sharded(c, co, b, w):
        img = rasterise_sharded(
            b, c, co, faces, mesh_t, axis="tiles", config=config
        )
        return jnp.sum(img * w)

    t_sh = t_of(sharded)
    print(f"sharded n=1       {t_sh*1e3:7.3f} ms "
          f"(tax {(t_sh-t_plain)*1e3:+.3f})")

    for k in (1, 2, 4):
        def overl(c, co, b, w, k=k):
            img = rasterise_sharded(
                b, c, co, faces, mesh_t, axis="tiles", config=config,
                overlap_chunks=k,
            )
            return jnp.sum(img * w)

        t_ov = t_of(overl)
        print(f"overlap chunks={k} {t_ov*1e3:7.3f} ms "
              f"(tax {(t_ov-t_plain)*1e3:+.3f})")

    def face_sh(c, co, b, w):
        img = rasterise_face_sharded(
            b, c, co, faces, mesh_f, config=config
        )
        return jnp.sum(img * w)

    t_f = t_of(face_sh)
    print(f"face-sharded n=1  {t_f*1e3:7.3f} ms "
          f"(tax {(t_f-t_plain)*1e3:+.3f})")


if __name__ == "__main__":
    main()
