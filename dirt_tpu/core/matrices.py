"""Transformation and projection matrices (pure JAX).

Functional parity with the reference's ``dirt/matrices.py`` (reconstructed;
see SURVEY.md section 2.2): ``translation``, ``rodrigues``,
``perspective_projection``, ``compose``, ``pad_3x3_to_4x4``, plus
``rotation_x/y/z``, ``scale`` and ``orthographic_projection`` helpers.

Conventions (matching the reference / TensorFlow-style graphics code):

* **Row-vector convention.** Points are rows, transforms post-multiply:
  ``v_out = v_in @ M``. Matrices here are therefore the transpose of the
  column-vector OpenGL forms.
* Clip space is OpenGL-style: after ``v_clip = v_obj @ M @ V @ P`` a point
  is visible iff ``-w <= x, y, z <= w``; NDC z in [-1, 1].
* All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _eye_like(batch_shape, dtype):
    eye = jnp.eye(4, dtype=dtype)
    return jnp.broadcast_to(eye, batch_shape + (4, 4))


def translation(t):
    """4x4 translation matrix for row vectors.

    Args:
        t: [..., 3] translation.
    Returns:
        [..., 4, 4] matrix with the translation in the bottom row.
    """
    t = jnp.asarray(t)
    batch = t.shape[:-1]
    m = _eye_like(batch, t.dtype)
    m = m.at[..., 3, 0].set(t[..., 0])
    m = m.at[..., 3, 1].set(t[..., 1])
    m = m.at[..., 3, 2].set(t[..., 2])
    return m


def scale(s):
    """4x4 (possibly non-uniform) scale matrix.

    Args:
        s: scalar, [..., 1] or [..., 3] scale factors.
    """
    s = jnp.asarray(s)
    if s.ndim == 0:
        s = s[None]
    if s.shape[-1] == 1:
        s = jnp.concatenate([s, s, s], axis=-1)
    batch = s.shape[:-1]
    m = _eye_like(batch, s.dtype)
    m = m.at[..., 0, 0].set(s[..., 0])
    m = m.at[..., 1, 1].set(s[..., 1])
    m = m.at[..., 2, 2].set(s[..., 2])
    return m


def rodrigues(axis_angle, epsilon: float = 1e-12):
    """Axis-angle rotation to a 4x4 matrix (row-vector convention).

    The rotation angle is the norm of ``axis_angle``; the axis its direction.
    Differentiable at zero (guarded normalisation).

    Args:
        axis_angle: [..., 3].
    Returns:
        [..., 4, 4].
    """
    aa = jnp.asarray(axis_angle)
    theta = jnp.sqrt(jnp.sum(aa * aa, axis=-1) + epsilon)
    axis = aa / theta[..., None]
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    one_c = 1.0 - c

    # Column-vector rotation matrix R (v' = R v), then transpose for rows.
    r00 = c + x * x * one_c
    r01 = x * y * one_c - z * s
    r02 = x * z * one_c + y * s
    r10 = y * x * one_c + z * s
    r11 = c + y * y * one_c
    r12 = y * z * one_c - x * s
    r20 = z * x * one_c - y * s
    r21 = z * y * one_c + x * s
    r22 = c + z * z * one_c
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    # Row-vector matrix = R^T.
    m = jnp.stack(
        [
            jnp.stack([r00, r10, r20, zero], axis=-1),
            jnp.stack([r01, r11, r21, zero], axis=-1),
            jnp.stack([r02, r12, r22, zero], axis=-1),
            jnp.stack([zero, zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    return m


def _axis_rotation(theta, i, j):
    theta = jnp.asarray(theta)
    c, s = jnp.cos(theta), jnp.sin(theta)
    m = _eye_like(theta.shape, theta.dtype)
    # Row-vector convention (transpose of the column form).
    m = m.at[..., i, i].set(c)
    m = m.at[..., i, j].set(s)
    m = m.at[..., j, i].set(-s)
    m = m.at[..., j, j].set(c)
    return m


def rotation_x(theta):
    """Rotation about +x by ``theta`` (radians), row-vector convention."""
    return _axis_rotation(theta, 1, 2)


def rotation_y(theta):
    """Rotation about +y by ``theta`` (radians), row-vector convention."""
    return _axis_rotation(theta, 2, 0)


def rotation_z(theta):
    """Rotation about +z by ``theta`` (radians), row-vector convention."""
    return _axis_rotation(theta, 0, 1)


def perspective_projection(near, far, right, aspect):
    """OpenGL-style symmetric perspective frustum (row-vector convention).

    The frustum spans x in [-right, right] and y in [-top, top] at the near
    plane, with ``top = right * aspect`` (aspect = height / width). The
    camera looks down -z; depths in [-near, -far] map to NDC z in [-1, 1].

    Returns:
        [4, 4] matrix P such that ``v_clip = v_eye @ P``.
    """
    near = jnp.asarray(near, jnp.float32)
    far = jnp.asarray(far, jnp.float32)
    right = jnp.asarray(right, jnp.float32)
    aspect = jnp.asarray(aspect, jnp.float32)
    top = right * aspect
    zero = jnp.zeros_like(near)
    # Column-vector GL matrix, written transposed.
    elements = [
        [near / right, zero, zero, zero],
        [zero, near / top, zero, zero],
        [zero, zero, -(far + near) / (far - near), -jnp.ones_like(near)],
        [zero, zero, -2.0 * far * near / (far - near), zero],
    ]
    return jnp.stack([jnp.stack(row, axis=-1) for row in elements], axis=-2)


def orthographic_projection(near, far, right, aspect):
    """Symmetric orthographic projection (row-vector convention)."""
    near = jnp.asarray(near, jnp.float32)
    far = jnp.asarray(far, jnp.float32)
    right = jnp.asarray(right, jnp.float32)
    aspect = jnp.asarray(aspect, jnp.float32)
    top = right * aspect
    zero = jnp.zeros_like(near)
    one = jnp.ones_like(near)
    elements = [
        [1.0 / right, zero, zero, zero],
        [zero, 1.0 / top, zero, zero],
        [zero, zero, -2.0 / (far - near), zero],
        [zero, zero, -(far + near) / (far - near), one],
    ]
    return jnp.stack([jnp.stack(row, axis=-1) for row in elements], axis=-2)


def pad_3x3_to_4x4(m):
    """Embed a [..., 3, 3] linear transform into [..., 4, 4] homogeneous."""
    m = jnp.asarray(m)
    batch = m.shape[:-2]
    out = _eye_like(batch, m.dtype)
    out = out.at[..., :3, :3].set(m)
    return out


def compose(*matrices):
    """Compose transforms applied left-to-right on row vectors.

    ``compose(A, B, C)`` returns ``A @ B @ C`` so that
    ``v @ compose(A, B, C) == ((v @ A) @ B) @ C``. Products run at full
    f32 precision: on the GPU a default-precision f32 matmul may use TF32,
    whose ~1e-3 relative error moves 1024^2 screen positions by up to half
    a pixel and flips coverage at edges.
    """
    result = jnp.asarray(matrices[0])
    for m in matrices[1:]:
        result = jnp.matmul(
            result, jnp.asarray(m), precision=jax.lax.Precision.HIGHEST
        )
    return result


def transform_homogeneous(vertices, matrix):
    """Append w=1 to [..., V, 3] vertices and post-multiply by ``matrix``.

    Full f32 precision, for the reason given in :func:`compose`.
    """
    vertices = jnp.asarray(vertices)
    ones = jnp.ones(vertices.shape[:-1] + (1,), vertices.dtype)
    homog = jnp.concatenate([vertices, ones], axis=-1)
    return jnp.matmul(homog, matrix, precision=jax.lax.Precision.HIGHEST)
