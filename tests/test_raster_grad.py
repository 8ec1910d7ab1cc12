"""Backward pass vs the gradient oracle (SURVEY.md section 4).

Interior gradients are exact and checked tightly (against the independent
autodiff oracle and finite differences); boundary gradients are approximate
*by design* (DIRT semantics) and checked for exact agreement with the
oracle's implementation of the same model, plus directional sanity.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dirt_tpu.ops.raster import RasterConfig, rasterize_screen
from dirt_tpu.ref import slowref


def _screen_face(verts_xy, z=0.0, invw=1.0):
    verts_xy = np.asarray(verts_xy, np.float32)
    f = verts_xy.shape[0]
    z_arr = np.broadcast_to(np.asarray(z, np.float32), (f, 3))
    w_arr = np.broadcast_to(np.asarray(invw, np.float32), (f, 3))
    return np.concatenate(
        [verts_xy, z_arr[..., None], w_arr[..., None]], axis=-1
    ).astype(np.float32)


@functools.partial(jax.jit, static_argnums=(4,))
def _grads_jit(fv, fa, bg, gp, config):
    # Jitted: op-by-op eager execution pays a tiny per-op XLA compile
    # each (too small for the persistent cache) — measured 12+ s for ONE
    # eager binning call vs 1.7 s jit-compiled on this 1-core CPU.
    def render(fv, fa, bg):
        return rasterize_screen(fv, fa, bg, config)[0]

    out, vjp_fn = jax.vjp(render, fv, fa, bg)
    return (out,) + tuple(vjp_fn(gp))


def _grads(face_verts, face_attrs, background, grad_pixels, config=None):
    """Production backward: vjp of rasterize_screen's pixel output."""
    out, d_fv, d_fa, d_bg = _grads_jit(
        jnp.asarray(face_verts), jnp.asarray(face_attrs),
        jnp.asarray(background), jnp.asarray(grad_pixels),
        config or RasterConfig(),
    )
    return (np.asarray(out), np.asarray(d_fv), np.asarray(d_fa),
            np.asarray(d_bg))


def _oracle_grads(face_verts, face_attrs, background, grad_pixels):
    pixels, fid, zbuf = slowref.oracle_forward(face_verts, face_attrs, background)
    return pixels, slowref.oracle_backward(
        face_verts, face_attrs, background, fid, zbuf, pixels, grad_pixels
    )


@pytest.mark.slow
def test_backward_matches_oracle_single_triangle():
    face_verts = _screen_face([[[10.3, 50.2], [54.1, 49.7], [32.2, 10.6]]])
    face_attrs = np.array([[[0.9], [0.4], [0.1]]], np.float32)
    background = np.full((64, 64, 1), 0.2, np.float32)
    rng = np.random.RandomState(0)
    grad_pixels = rng.randn(64, 64, 1).astype(np.float32)

    pix, d_fv, d_fa, d_bg = _grads(face_verts, face_attrs, background, grad_pixels)
    ref_pix, (ref_d_fv, ref_d_fa, ref_d_bg) = _oracle_grads(
        face_verts, face_attrs, background, grad_pixels
    )
    np.testing.assert_allclose(pix, ref_pix, atol=1e-5)
    np.testing.assert_allclose(d_fa, ref_d_fa, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(d_bg, ref_d_bg, atol=1e-6)
    np.testing.assert_allclose(d_fv, ref_d_fv, rtol=2e-3, atol=2e-3)


def test_backward_matches_oracle_occlusion():
    """Two overlapping triangles: boundary grads go to the FRONT face."""
    face_verts = np.stack([
        _screen_face([[[8.4, 55.1], [56.2, 53.8], [30.1, 9.2]]], z=0.5)[0],
        _screen_face([[[20.3, 48.2], [44.6, 47.1], [33.8, 20.4]]], z=-0.5)[0],
    ])
    face_attrs = np.array(
        [[[0.9], [0.9], [0.9]], [[0.1], [0.2], [0.3]]], np.float32
    )
    background = np.zeros((64, 64, 1), np.float32)
    rng = np.random.RandomState(1)
    grad_pixels = rng.randn(64, 64, 1).astype(np.float32)

    pix, d_fv, d_fa, d_bg = _grads(face_verts, face_attrs, background, grad_pixels)
    ref_pix, (ref_d_fv, ref_d_fa, ref_d_bg) = _oracle_grads(
        face_verts, face_attrs, background, grad_pixels
    )
    np.testing.assert_allclose(pix, ref_pix, atol=1e-5)
    np.testing.assert_allclose(d_fa, ref_d_fa, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(d_fv, ref_d_fv, rtol=2e-3, atol=2e-3)


def test_backward_matches_oracle_perspective():
    face_verts = np.array(
        [[[6.2, 6.3, -0.5, 1.0], [57.6, 6.1, 0.5, 0.25],
          [30.9, 57.8, 0.0, 0.6]]],
        np.float32,
    )
    face_attrs = np.array([[[0.1, 0.8], [0.9, 0.2], [0.5, 0.5]]], np.float32)
    background = np.zeros((64, 64, 2), np.float32)
    rng = np.random.RandomState(2)
    grad_pixels = rng.randn(64, 64, 2).astype(np.float32)

    pix, d_fv, d_fa, d_bg = _grads(face_verts, face_attrs, background, grad_pixels)
    ref_pix, (ref_d_fv, ref_d_fa, ref_d_bg) = _oracle_grads(
        face_verts, face_attrs, background, grad_pixels
    )
    np.testing.assert_allclose(pix, ref_pix, atol=1e-5)
    np.testing.assert_allclose(d_fa, ref_d_fa, rtol=1e-4, atol=1e-4)
    # invw column participates (perspective correction) — check it too.
    np.testing.assert_allclose(d_fv, ref_d_fv, rtol=2e-3, atol=2e-3)
    assert np.abs(ref_d_fv[0, :, 3]).max() > 0


def test_interior_attr_grads_match_finite_differences():
    face_verts = _screen_face([[[6.3, 26.2], [28.1, 25.7], [16.2, 6.6]]])
    face_attrs = np.array([[[0.9], [0.4], [0.1]]], np.float32)
    background = np.zeros((32, 32, 1), np.float32)
    config = RasterConfig()

    def loss_np(fa):
        pix, _, _ = slowref.oracle_forward(face_verts, fa, background)
        return float((pix**2).sum())

    def loss_jax(fa):
        pix = rasterize_screen(
            jnp.asarray(face_verts), fa, jnp.asarray(background), config
        )[0]
        return jnp.sum(pix**2)

    g = np.asarray(jax.grad(loss_jax)(jnp.asarray(face_attrs)))
    eps = 1e-3
    for k in range(3):
        fa_p = face_attrs.copy(); fa_p[0, k, 0] += eps
        fa_m = face_attrs.copy(); fa_m[0, k, 0] -= eps
        fd = (loss_np(fa_p) - loss_np(fa_m)) / (2 * eps)
        np.testing.assert_allclose(g[0, k, 0], fd, rtol=1e-2)


def test_silhouette_gradient_direction():
    """Moving a white triangle toward a shifted white target must be the
    descent direction of the L2 loss — the classic DIRT/OpenDR sanity check.
    Interior gradients alone are zero here (flat colors), so this isolates
    the boundary term."""
    base = np.array([[[14.3, 50.2], [50.1, 49.7], [32.2, 12.6]]], np.float32)
    face_attrs = np.ones((1, 3, 1), np.float32)
    background = np.zeros((64, 64, 1), np.float32)
    config = RasterConfig()

    target_verts = base.copy()
    target_verts[..., 0] += 4.0  # target shifted right
    target, _, _ = slowref.oracle_forward(
        _screen_face_from_xy(target_verts), face_attrs, background
    )

    def loss(fv):
        pix = rasterize_screen(
            fv, jnp.asarray(face_attrs), jnp.asarray(background), config
        )[0]
        return 0.5 * jnp.sum((pix - target) ** 2)

    g = np.asarray(jax.grad(loss)(jnp.asarray(_screen_face_from_xy(base))))
    # Descent direction: -g must push x coordinates right (positive).
    assert (-g[0, :, 0] > 0).all(), g[0, :, 0]
    # And essentially no vertical pull.
    assert np.abs(g[0, :, 1]).sum() < 0.5 * np.abs(g[0, :, 0]).sum()


def _screen_face_from_xy(xy):
    return _screen_face(xy)


def test_gradient_descent_converges_on_translation():
    """Plain GD steps shrink a 3px offset (integration-level check
    that boundary + interior grads drive optimization the right way)."""
    target_xy = np.array([[[20.3, 44.2], [44.1, 43.7], [32.2, 16.6]]], np.float32)
    face_attrs = np.ones((1, 3, 1), np.float32) * 0.8
    background = np.zeros((64, 64, 1), np.float32)
    config = RasterConfig()
    target, _, _ = slowref.oracle_forward(
        _screen_face(target_xy), face_attrs, background
    )

    offset0 = jnp.array([3.0, -2.0])

    @jax.jit
    def loss(offset):
        xy = jnp.asarray(target_xy) + offset[None, None, :]
        fv = jnp.concatenate(
            [xy, jnp.zeros((1, 3, 1)), jnp.ones((1, 3, 1))], axis=-1
        )
        pix = rasterize_screen(
            fv, jnp.asarray(face_attrs), jnp.asarray(background), config
        )[0]
        return 0.5 * jnp.sum((pix - target) ** 2)

    grad_fn = jax.jit(jax.grad(loss))
    offset = offset0
    lr = 7e-3
    for _ in range(60):
        offset = offset - lr * grad_fn(offset)
    assert float(loss(offset)) < 0.25 * float(loss(offset0)), (
        float(loss(offset0)), float(loss(offset)),
    )
    assert float(jnp.abs(offset).max()) < 2.0, offset


# ---------------------------------------------------------------------------
# Packed engine: same gradient semantics as the dense engine.
# ---------------------------------------------------------------------------


def _soup(seed=5, num_faces=90, height=96, width=160, channels=3):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(
        [10, 10], [width - 10, height - 10], (num_faces, 1, 2))
    xy = (centers + rng.uniform(-22, 22, (num_faces, 3, 2))).astype(
        np.float32)
    z = rng.uniform(-0.9, 0.9, (num_faces, 1)).astype(np.float32)
    face_verts = _screen_face(xy, z=z)
    # Perspective-varying invw to exercise the denominator terms.
    face_verts[..., 3] = rng.uniform(0.4, 1.6, (num_faces, 3))
    face_attrs = rng.rand(num_faces, 3, channels).astype(np.float32)
    background = rng.rand(height, width, channels).astype(np.float32)
    grad_pixels = rng.randn(height, width, channels).astype(np.float32)
    return face_verts, face_attrs, background, grad_pixels


@pytest.mark.slow
def test_packed_backward_matches_dense_backward():
    face_verts, face_attrs, background, grad_pixels = _soup()
    _, d_fv_d, d_fa_d, d_bg_d = _grads(
        face_verts, face_attrs, background, grad_pixels,
        RasterConfig(engine="dense"))
    _, d_fv_p, d_fa_p, d_bg_p = _grads(
        face_verts, face_attrs, background, grad_pixels,
        RasterConfig(engine="packed"))
    np.testing.assert_allclose(d_bg_p, d_bg_d, atol=1e-6)
    np.testing.assert_allclose(d_fa_p, d_fa_d, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d_fv_p, d_fv_d, rtol=1e-3, atol=1e-3)


@pytest.mark.slow
def test_packed_backward_matches_oracle():
    face_verts, face_attrs, background, grad_pixels = _soup(seed=9)
    pix, d_fv, d_fa, d_bg = _grads(
        face_verts, face_attrs, background, grad_pixels,
        RasterConfig(engine="packed"))
    ref_pix, (ref_d_fv, ref_d_fa, ref_d_bg) = _oracle_grads(
        face_verts, face_attrs, background, grad_pixels)
    # A couple of boundary pixels may differ between f32/f64 engines;
    # compare where coverage agrees (bulk) and overall magnitudes.
    np.testing.assert_allclose(d_bg, ref_d_bg, atol=1e-5)
    np.testing.assert_allclose(d_fa, ref_d_fa, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(d_fv, ref_d_fv, rtol=5e-3, atol=5e-3)
