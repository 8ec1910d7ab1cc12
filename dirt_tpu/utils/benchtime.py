"""Device time of a workload, with host dispatch overhead cancelled.

``device_time`` compiles a fori_loop that re-runs the workload R times
with a data-dependent perturbation (so XLA cannot CSE the iterations),
fetches a scalar (which forces completion), and differences two
repetition counts so the fixed launch and fetch overhead cancels:

    t_per_rep = (T(r2) - T(r1)) / (r2 - r1)
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def _loop_runner(fn, example_args, reps):
    """Build a jitted scalar-returning function running ``fn`` reps times.

    The workload arrays are jit PARAMETERS, not closure constants: embedded
    constants invite XLA constant-folding passes that bloat the executable
    and its compile time. The data-dependent perturbation below already
    defeats CSE across iterations either way.
    """

    def run(*args):
        def body(i, acc):
            # Perturb the first argument by a tiny data-dependent amount so
            # iterations cannot be collapsed; the perturbation (1e-30 * acc)
            # is far below f32 resolution of any practical input.
            eps = acc * 1e-30
            a = [args[0] + eps] + list(args[1:])
            out = fn(*a)
            leaves = jax.tree_util.tree_leaves(out)
            s = sum(jnp.sum(leaf.astype(jnp.float32)) for leaf in leaves)
            return acc + s * 1e-30
        return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

    jitted = jax.jit(run)
    return lambda: jitted(*example_args)


def device_time(fn, example_args, r1: int = 2, r2: int = 12,
                samples: int = 3) -> float:
    """Best-estimate seconds per invocation of ``fn(*example_args)``."""
    return device_time_stats(fn, example_args, r1, r2, samples)[0]


def device_time_stats(fn, example_args, r1: int = 2, r2: int = 12,
                      samples: int = 3,
                      _retry: bool = True) -> tuple[float, float]:
    """(min, median) seconds per invocation, from per-sample estimates.

    Host noise is one-sided (spikes), so the min is the robust point
    estimate; the median is reported alongside so callers can print the
    spread.

    A sample whose difference comes out non-positive (every r1 baseline
    run was slowed more than the r2 run — possible when (r2 - r1) * t is
    of the order of the host jitter) is INVALID, not a fast measurement:
    such samples are dropped, and if none survive the whole measurement
    retries once with 4x the rep spread. If that also yields nothing, it
    raises instead of returning an estimate.
    """
    f1 = _loop_runner(fn, example_args, r1)
    f2 = _loop_runner(fn, example_args, r2)
    float(f1())  # compile + warm
    float(f2())

    def sample(f):
        vals = []
        for _ in range(samples):
            t0 = time.perf_counter()
            float(f())
            vals.append(time.perf_counter() - t0)
        return vals

    t1s = sample(f1)
    t2s = sample(f2)
    # Baseline (r1 reps) uses its min: its own spikes would *shrink* the
    # difference and bias every estimate low.
    t1 = min(t1s)
    ests = sorted(
        (t2 - t1) / (r2 - r1) for t2 in t2s if t2 - t1 > 0
    )
    if not ests:
        if _retry:
            return device_time_stats(
                fn, example_args, r1, r1 + 4 * (r2 - r1), samples,
                _retry=False,
            )
        raise RuntimeError(
            "device_time: no valid sample (every r2 run was no slower "
            "than the r1 baseline); raise r2"
        )
    t_min = ests[0]
    t_med = ests[len(ests) // 2]
    return t_min, t_med
