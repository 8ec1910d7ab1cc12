import jax
import jax.numpy as jnp
import pytest
import numpy as np

from dirt_tpu.core import matrices


def test_translation_moves_points():
    m = matrices.translation(jnp.array([1.0, 2.0, 3.0]))
    v = jnp.array([[0.0, 0.0, 0.0, 1.0], [1.0, 1.0, 1.0, 1.0]])
    out = v @ m
    np.testing.assert_allclose(out[0, :3], [1.0, 2.0, 3.0], atol=1e-6)
    np.testing.assert_allclose(out[1, :3], [2.0, 3.0, 4.0], atol=1e-6)


def test_rodrigues_quarter_turn_about_z():
    m = matrices.rodrigues(jnp.array([0.0, 0.0, np.pi / 2]))
    v = jnp.array([1.0, 0.0, 0.0, 1.0])
    out = v @ m
    np.testing.assert_allclose(out[:3], [0.0, 1.0, 0.0], atol=1e-5)


def test_rodrigues_matches_rotation_helpers():
    theta = 0.37
    np.testing.assert_allclose(
        matrices.rodrigues(jnp.array([theta, 0.0, 0.0])),
        matrices.rotation_x(theta),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        matrices.rodrigues(jnp.array([0.0, theta, 0.0])),
        matrices.rotation_y(theta),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        matrices.rodrigues(jnp.array([0.0, 0.0, theta])),
        matrices.rotation_z(theta),
        atol=1e-5,
    )


def test_rodrigues_is_rotation_matrix():
    rng = np.random.RandomState(0)
    for _ in range(5):
        aa = rng.randn(3).astype(np.float32)
        m = np.asarray(matrices.rodrigues(jnp.asarray(aa)))[:3, :3]
        np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-5)
        assert np.linalg.det(m) > 0.99


def test_perspective_projection_maps_frustum_corners():
    near, far, right, aspect = 0.1, 10.0, 0.05, 1.0
    p = matrices.perspective_projection(near, far, right, aspect)
    # A point on the near plane at the +x frustum edge -> NDC (+1, ., -1).
    v = jnp.array([right, 0.0, -near, 1.0])
    clip = v @ p
    ndc = clip[:3] / clip[3]
    np.testing.assert_allclose(ndc[0], 1.0, atol=1e-5)
    np.testing.assert_allclose(ndc[2], -1.0, atol=1e-5)
    # Far-plane center -> NDC z = +1.
    v = jnp.array([0.0, 0.0, -far, 1.0])
    clip = v @ p
    np.testing.assert_allclose(clip[2] / clip[3], 1.0, atol=1e-4)


def test_orthographic_projection():
    p = matrices.orthographic_projection(0.1, 10.0, 2.0, 1.0)
    v = jnp.array([2.0, -2.0, -10.0, 1.0])
    clip = v @ p
    np.testing.assert_allclose(clip[3], 1.0, atol=1e-6)
    np.testing.assert_allclose(clip[0], 1.0, atol=1e-6)
    np.testing.assert_allclose(clip[1], -1.0, atol=1e-6)
    np.testing.assert_allclose(clip[2], 1.0, atol=1e-5)


def test_compose_order():
    t1 = matrices.translation(jnp.array([1.0, 0.0, 0.0]))
    r = matrices.rotation_z(np.pi / 2)
    m = matrices.compose(t1, r)
    v = jnp.array([0.0, 0.0, 0.0, 1.0])
    # Translate first, then rotate: (1,0,0) -> (0,1,0).
    np.testing.assert_allclose((v @ m)[:3], [0.0, 1.0, 0.0], atol=1e-5)


def test_pad_3x3_to_4x4():
    m3 = jnp.arange(9.0).reshape(3, 3)
    m4 = matrices.pad_3x3_to_4x4(m3)
    assert m4.shape == (4, 4)
    np.testing.assert_allclose(m4[:3, :3], m3)
    np.testing.assert_allclose(m4[3], [0, 0, 0, 1])


def test_transform_homogeneous():
    m = matrices.translation(jnp.array([0.0, 0.0, -5.0]))
    v = jnp.zeros((2, 3))
    out = matrices.transform_homogeneous(v, m)
    assert out.shape == (2, 4)
    np.testing.assert_allclose(out[:, 2], [-5.0, -5.0])


def _random_transform(seed):
    rng = np.random.RandomState(seed)
    m = matrices.compose(
        matrices.rodrigues(jnp.asarray(rng.uniform(-2, 2, 3), jnp.float32)),
        matrices.translation(
            jnp.asarray(rng.uniform(-5, 5, 3), jnp.float32)),
        matrices.perspective_projection(0.1, 20.0, 0.045, 1.0),
    )
    verts = rng.uniform(-1, 1, (257, 3)).astype(np.float32)
    return np.asarray(m), verts


@pytest.mark.parametrize("fn", ["compose", "transform_homogeneous"])
def test_products_are_pinned_to_full_f32(fn):
    """Both products ask for HIGHEST precision (never TF32 on a GPU) and
    match float64 NumPy to f32 rounding."""
    m, verts = _random_transform(3)
    if fn == "compose":
        args = (jnp.asarray(m), jnp.asarray(m.T))
        want = m.astype(np.float64) @ m.T.astype(np.float64)
    else:
        args = (jnp.asarray(verts), jnp.asarray(m))
        homog = np.concatenate([verts, np.ones((257, 1), np.float32)], 1)
        want = homog.astype(np.float64) @ m.astype(np.float64)
    f = getattr(matrices, fn)
    assert "HIGHEST" in str(jax.make_jaxpr(f)(*args))
    got = np.asarray(jax.jit(f)(*args), np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-6 * scale, rtol=0)
