"""Where the device time of one fwd+bwd step goes, read from a profiler trace.

Traces a few warmed steps of the 10k-face sphere at 1024^2 (clip off,
honest caps, gradients to vertices, colours and background) with
``jax.profiler``, then reads the trace back with
``jax.profiler.ProfileData`` and prints, for the GPU plane:

* the window's device busy share (union of kernel intervals / window);
* device time per stage — the ``dirt_*`` named scope found in a kernel's
  stats (dirt_setup, dirt_binning*, dirt_raster_fwd, dirt_raster_bwd), or
  ``other``;
* the top kernels by total device time.

Run on a machine with a GPU: python tools/prof_trace.py [size] [steps]
The trace is written under chiprun_out/trace (listed in .gitignore).
"""

import collections
import glob
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dirt_tpu.utils.compilecache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import dirt_tpu  # noqa: E402
from dirt_tpu.core import matrices, mesh  # noqa: E402

SCOPE = re.compile(r"dirt_[a-z_]+")


def _scene(size):
    verts_obj, faces, _ = mesh.uv_sphere(n_lat=72, n_lon=72)
    mv = matrices.compose(
        matrices.rodrigues(jnp.array([0.4, 0.3, 0.0])),
        matrices.translation(jnp.array([0.0, 0.0, -3.0])),
    )
    proj = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    clip = matrices.transform_homogeneous(
        jnp.asarray(verts_obj), matrices.compose(mv, proj))
    faces = jnp.asarray(faces)
    colors = jnp.asarray(np.random.RandomState(0).rand(len(verts_obj), 3),
                         jnp.float32)
    config = dirt_tpu.suggest_raster_config(clip, faces, size, size,
                                            clip=False)
    bg = jnp.zeros((size, size, 3), jnp.float32)
    _, _, _, overflow = dirt_tpu.rasterise_with_aux(
        bg, clip, colors, faces, config=config, clip=False)
    assert not bool(overflow), "scene must render untruncated"
    w = jnp.asarray(np.random.RandomState(1).rand(size, size, 3),
                    jnp.float32)
    return clip, colors, faces, bg, w, config


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"needs a GPU, found {jax.devices()}")
    clip, colors, faces, bg, w, config = _scene(size)

    def loss(v, c, b, w):
        img = dirt_tpu.rasterise(b, v, c, faces, config=config, clip=False)
        return jnp.sum(img * w)

    step = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
    args = (clip, colors, bg, w)
    jax.block_until_ready(step(*args))
    jax.block_until_ready(step(*args))

    out = os.path.join(ROOT, "chiprun_out", "trace")
    shutil.rmtree(out, ignore_errors=True)
    with jax.profiler.trace(out):
        for _ in range(steps):
            jax.block_until_ready(step(*args))
    path = glob.glob(os.path.join(out, "**", "*.xplane.pb"), recursive=True)
    data = jax.profiler.ProfileData.from_file(path[0])

    per_kernel = collections.Counter()
    per_stage = collections.Counter()
    intervals = []
    shown = False
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if ev.duration_ns <= 0:
                    continue
                stats = {k: v for k, v in ev.stats}
                if not shown:
                    print(f"# sample event {ev.name!r} stats {stats}")
                    shown = True
                text = " ".join(str(v) for v in stats.values())
                m = SCOPE.search(text) or SCOPE.search(ev.name)
                per_stage[m.group(0) if m else "other"] += ev.duration_ns
                per_kernel[ev.name] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        sys.exit("no GPU events in the trace")
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = _union_ns(intervals)
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    print(f"# {card}; {size}^2 10k sphere fwd+bwd, {steps} traced steps")
    print(f"device busy {busy / 1e6 / steps:.3f} ms/step of a "
          f"{window / 1e6 / steps:.3f} ms/step window "
          f"(idle share {1 - busy / window:.3f})")
    total = sum(per_stage.values())
    for name, ns in per_stage.most_common():
        print(f"  stage {name:24s} {ns / 1e6 / steps:8.3f} ms/step "
              f"({ns / total:.1%})")
    for name, ns in per_kernel.most_common(25):
        print(f"  kernel {name[:60]:60s} {ns / 1e6 / steps:8.3f} ms/step")


if __name__ == "__main__":
    main()
