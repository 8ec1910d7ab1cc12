"""Auxiliary subsystems: checkpointing, metrics logging (SURVEY.md §5)."""

import os

import jax.numpy as jnp
import numpy as np

from dirt_tpu.utils.checkpoint import load_pytree, save_pytree
from dirt_tpu.utils.metrics import MetricsLogger


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "params": {"pose": jnp.arange(3.0), "bump": jnp.ones((7,))},
        "opt": (jnp.zeros((2, 2)), jnp.int32(5)),
        "steps": [jnp.float32(1.5), jnp.float32(2.5)],
    }
    path = os.path.join(tmp_path, "ckpt.npz")
    save_pytree(path, tree)
    restored = load_pytree(path)
    assert set(restored) == {"params", "opt", "steps"}
    np.testing.assert_array_equal(
        restored["params"]["pose"], np.arange(3.0))
    assert isinstance(restored["opt"], tuple)
    assert restored["opt"][1] == 5
    assert isinstance(restored["steps"], list)
    assert restored["steps"][1] == 2.5


def test_checkpoint_rejects_unknown_nodes(tmp_path):
    # ADVICE.md round 1: custom registered nodes (e.g. optax states) and
    # non-string dict keys must fail loudly, not corrupt leaf order.
    import jax
    import pytest

    class Box:
        def __init__(self, value):
            self.value = value

    jax.tree_util.register_pytree_node(
        Box, lambda b: ((b.value,), None), lambda _, c: Box(c[0])
    )
    path = os.path.join(tmp_path, "bad.npz")
    with pytest.raises(TypeError, match="pytree node|plain"):
        save_pytree(path, {"opt": Box(jnp.zeros(3))})
    with pytest.raises(TypeError, match="keys must be strings"):
        save_pytree(path, {1: jnp.zeros(2)})


def test_metrics_logger_csv(tmp_path):
    path = os.path.join(tmp_path, "m.csv")
    logger = MetricsLogger(path, print_every=100)
    for i in range(5):
        logger.log(i, loss=1.0 / (i + 1), mpix_s=10.0 * i)
    logger.close()
    lines = open(path).read().strip().splitlines()
    assert lines[0] == "step,wall_s,loss,mpix_s"
    assert len(lines) == 6
    last = lines[-1].split(",")
    assert last[0] == "4" and float(last[2]) == 0.2


def test_checkpoint_none_leaves(tmp_path):
    tree = {"a": None, "b": jnp.arange(4.0), "c": [None, jnp.ones(2)]}
    path = os.path.join(tmp_path, "none.npz")
    save_pytree(path, tree)
    restored = load_pytree(path)
    assert restored["a"] is None
    np.testing.assert_array_equal(restored["b"], np.arange(4.0))
    assert restored["c"][0] is None
    np.testing.assert_array_equal(restored["c"][1], np.ones(2))


def test_compile_cache_yields_to_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that is the cache, and this
    module sets no other directory in JAX's config."""
    import jax

    from dirt_tpu.utils import compilecache

    before = jax.config.jax_compilation_cache_dir
    where = str(tmp_path / "cache")
    monkeypatch.setenv(compilecache.ENV_VAR, where)
    assert compilecache.enable_compile_cache() == where
    assert os.path.isdir(where)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_ignored_dir_in_checkout(monkeypatch):
    from dirt_tpu.utils import compilecache

    monkeypatch.delenv(compilecache.ENV_VAR, raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compilecache.cache_dir() == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
