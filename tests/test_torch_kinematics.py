"""srl_tpu_torch.ops.kinematics against srl_tpu.ops.kinematics on the CPU.

Tolerances: fk at atol 1e-5 (float32 chain of 7 Givens updates); dls_ik and
control_step at rtol 1e-4 (the reference's unrolled spd_solve is about 4e-5
relative, kinematics.py:225-227), with atol 1e-6 for entries that are exactly
zero; settled_rest_q at atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.ops import kinematics as jkin
from srl_tpu_torch.ops import kinematics as tkin

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    q = (jkin.REST_Q + rng.normal(0, 0.3, (16, 7))).astype(np.float32)
    target = (np.array([0.55, 0.0, 0.1]) + rng.uniform(-0.15, 0.15, (16, 3))).astype(
        np.float32)
    return q, target


def test_fk_matches(inputs):
    q, _ = inputs
    ref = jax.vmap(jkin.fk)(jnp.asarray(q))
    out = tkin.fk(torch.from_numpy(q))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def test_ik_down_and_limited_match(inputs):
    _, target = inputs
    for jf, tf in ((jkin.ik_down, tkin.ik_down),
                   (jkin.ik_down_limited, tkin.ik_down_limited)):
        ref = np.asarray(jax.vmap(jf)(jnp.asarray(target)))
        out = tf(torch.from_numpy(target)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_spd_solve_matches():
    rng = np.random.default_rng(1)
    m = rng.normal(size=(8, 6, 6)).astype(np.float32)
    a = (m @ m.transpose(0, 2, 1) + 0.1 * np.eye(6, dtype=np.float32)).astype(np.float32)
    b = rng.normal(size=(8, 6)).astype(np.float32)
    ref = np.asarray(jax.vmap(jkin.spd_solve)(jnp.asarray(a), jnp.asarray(b)))
    out = tkin.spd_solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("null_space", [False, True])
def test_dls_ik_matches(inputs, null_space):
    q, target = inputs
    ref = np.asarray(jax.vmap(
        lambda a, b: jkin.dls_ik(a, b, null_space=null_space))(
            jnp.asarray(q), jnp.asarray(target)))
    out = tkin.dls_ik(torch.from_numpy(q), torch.from_numpy(target),
                      null_space=null_space).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("null_space", [False, True])
def test_control_and_servo_step_match(inputs, null_space):
    q, target = inputs
    ref = np.asarray(jax.vmap(
        lambda a, b: jkin.control_step(a, b, null_space=null_space))(
            jnp.asarray(q), jnp.asarray(target)))
    out = tkin.control_step(torch.from_numpy(q), torch.from_numpy(target),
                            null_space=null_space).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)
    q_t = q[::-1].copy()
    ref = np.asarray(jax.vmap(jkin.servo_step)(jnp.asarray(q), jnp.asarray(q_t)))
    out = tkin.servo_step(torch.from_numpy(q), torch.from_numpy(q_t)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def test_settled_rest_q_matches():
    np.testing.assert_allclose(tkin.settled_rest_q(), jkin.settled_rest_q(),
                               atol=1e-5, rtol=0)
