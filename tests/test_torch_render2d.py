"""The port's MobileRobot sprite compositor against the reference.

The compositor is integer selects over pre-quantized colours and float32
compares, so the plain twin ``render_mobile_robot_plain`` must be bit-equal
to the reference's XLA compositor (srl_tpu/ops/renderer.py,
``render_mobile_robot``, vmapped) for all four variants, on reset states,
stepped states and placed robots (against a wall, over a target). On the
reference's own cases (tests/test_pallas_render.py) it must also be
bit-equal to the Pallas kernel in interpret mode. The two reference paths
round the disk test ``dy2 + dx2 <= r*r`` differently (XLA fuses ``dx * dx``
into the sum, the Pallas kernel ``dy * dy``), which flips an edge pixel for
rare target centres; the twin follows XLA, and is held to it on such
centres (``EDGE_CENTRES``).
The host tables (coordinates, background, packed colours) are equal to the
reference's. The first-person view is float ray tracing and meets the
render agreement of tests/test_pallas_render.py (over 99.5% of values
equal, under 0.5% off by more than 2).

The ``gpu`` tests hold the CUDA kernel bit-equal to the twin on the card,
at 224x224 and at small shapes whose pixel count is not a multiple of the
kernel's 512-pixel warp span, with and without the first-person channels.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from srl_tpu_torch import bridge
from srl_tpu_torch.envs import mobile_robot as tm
from srl_tpu_torch.ops import render2d
from srl_tpu_torch.ops import renderer as rr

torch.set_num_threads(1)

VARIANTS = ["MobileRobotEnv", "MobileRobot1DEnv", "MobileRobot2TargetEnv",
            "MobileRobotLineTargetEnv"]


@pytest.fixture(scope="module")
def jax_ref():
    """(jax, reference env module, reference renderer), imported here so
    that the ``gpu`` test also runs where JAX is not installed."""
    jax = pytest.importorskip("jax")
    from srl_tpu.envs import mobile_robot as jm
    from srl_tpu.ops import renderer as jr

    return jax, jm, jr


def port_states(jstates):
    arrays = {f.name: np.asarray(getattr(jstates, f.name)) for f in dataclasses.fields(jstates)}
    return bridge.state_from_numpy(tm.MobileRobotState, arrays)


@functools.lru_cache(maxsize=None)
def _jax_render(jenv):
    import jax

    return jax.jit(jax.vmap(jenv.render_pixels))


def reference_states(jax, jenv, n, seed, n_steps):
    """``n`` reference envs after ``n_steps`` random steps, with env 0 on
    its target and env 1 against the low-x wall margin."""
    import jax.numpy as jnp

    states = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(seed), n))
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        states, _, _ = step(states, jnp.asarray(
            rng.integers(0, jenv.action_space.n, n).astype(np.int32)))
    pos = np.array(states.robot_pos)
    pos[0] = np.asarray(states.targets)[0, 0]
    pos[1, 0] = 0.43
    if jenv.dim == 1:
        pos[:, 1] = 0.0
    return states.replace(robot_pos=jnp.asarray(pos))


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("hw", [(224, 224), (48, 48), (30, 40)])
def test_static_tables_match(jax_ref, dim, hw):
    _, _, jr = jax_ref
    for mine, ref in zip(rr._mobile_robot_static_packed(dim, *hw),
                         jr._mobile_robot_static_packed(dim, *hw)):
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(mine, ref)
    for mine, ref in zip(rr._mobile_robot_static(dim, *hw), jr._mobile_robot_static(dim, *hw)):
        np.testing.assert_array_equal(mine, ref)
    for c in (rr.TARGET_YELLOW, rr.TARGET_RED, rr.ROBOT_BODY, rr.ROBOT_WHEEL):
        assert rr._pack_color(c) == jr._pack_color(c)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("random_target", [False, True])
def test_twin_matches_xla_compositor(jax_ref, variant, random_target):
    jax, jm, _ = jax_ref
    kwargs = dict(srl_model="raw_pixels", random_target=random_target)
    jenv, tenv = getattr(jm, variant)(**kwargs), getattr(tm, variant)(**kwargs)
    for n_steps in (0, 20):
        jstates = reference_states(jax, jenv, 8, seed=3 + n_steps, n_steps=n_steps)
        expect = np.asarray(_jax_render(jenv)(jstates))
        out = render2d.render_mobile_robot(tenv, port_states(jstates))
        assert out.dtype == torch.uint8 and out.shape == expect.shape == (8, 224, 224, 3)
        np.testing.assert_array_equal(out.numpy(), expect)


@pytest.mark.parametrize("variant", ["MobileRobotEnv", "MobileRobot2TargetEnv"])
def test_twin_matches_xla_at_a_small_shape(jax_ref, variant):
    jax, jm, _ = jax_ref
    kwargs = dict(srl_model="raw_pixels", random_target=True, render_shape=(48, 40))
    jenv, tenv = getattr(jm, variant)(**kwargs), getattr(tm, variant)(**kwargs)
    jstates = reference_states(jax, jenv, 8, seed=5, n_steps=10)
    np.testing.assert_array_equal(
        render2d.render_mobile_robot(tenv, port_states(jstates)).numpy(),
        np.asarray(_jax_render(jenv)(jstates)))


# Target centres where an edge pixel of the disk depends on which square
# of ``dy2 + dx2`` is fused into the sum: XLA's ``fma(dx, dx, dy2)`` (the
# twin's and the kernel's) and the Pallas kernel's ``fma(dy, dy, dx2)``
# disagree there. Found by ``disk_edge_centres`` (run
# ``python -m tests.test_torch_render2d``).
EDGE_CENTRES = np.array([
    [3.0762922763824463, 1.5066301822662354], [2.3326616287231445, 1.6475329399108887],
    [3.3902664184570312, 1.3462833166122437], [1.003393530845642, 0.605855405330658],
    [1.0585198402404785, 2.4320406913757324], [2.5036301612854004, 2.6179068088531494],
    [1.0201048851013184, 0.559009850025177], [1.3144490718841553, 0.8709049820899963],
    [2.356379270553589, 0.5790647864341736],
], np.float32)


def disk_masks(centres, xs, ys):
    """(x fused, y fused) disk masks [N, H, W] of the target disk at
    ``centres`` over the pixel coordinates ``xs`` [N, W] and ``ys`` [N, H]."""
    r2 = np.float32(rr.TARGET_RADIUS * rr.TARGET_RADIUS)
    dx = (xs - centres[:, :1])[:, None, :]
    dy = (ys - centres[:, 1:])[:, :, None]
    fused = lambda a, b: (a.astype(np.float64) * a + b * b).astype(np.float32) <= r2
    return fused(dx, dy), fused(dy, dx)


def disk_edge_centres(n_wanted, seed, chunk=20000, max_chunks=15):
    """Random target centres (float32) whose disk has a pixel where the two
    fused roundings disagree, searching a 27x27 pixel window around each; returns
    (centres, number searched)."""
    xs, ys, _ = rr._mobile_robot_static_packed(2, 224, 224)
    rng = np.random.default_rng(seed)
    off = np.arange(-13, 14)
    found, searched = [], 0
    for _ in range(max_chunks):
        c = rng.uniform(0.5, 3.5, (chunk, 2)).astype(np.float32)
        searched += chunk
        ix = np.clip(np.searchsorted(xs, c[:, 0])[:, None] + off, 0, 223)
        iy = np.clip(np.searchsorted(-ys, -c[:, 1])[:, None] + off, 0, 223)
        x_fused, y_fused = disk_masks(c, xs[ix], ys[iy])
        found.extend(c[(x_fused != y_fused).any((1, 2))])
        if len(found) >= n_wanted:
            break
    return np.array(found[:n_wanted], np.float32).reshape(-1, 2), searched


def edge_centre_states(jax, jenv):
    """Reference states with the target at each edge centre and the robot
    off the plate, so that only the disk is drawn."""
    import jax.numpy as jnp

    n = len(EDGE_CENTRES)
    states = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), n))
    return states.replace(targets=jnp.asarray(EDGE_CENTRES[:, None]),
                          robot_pos=jnp.full((n, 2), 100.0, jnp.float32))


def test_twin_matches_xla_where_roundings_differ(jax_ref):
    jax, jm, _ = jax_ref
    xs, ys, _ = rr._mobile_robot_static_packed(2, 224, 224)
    n = len(EDGE_CENTRES)
    x_fused, y_fused = disk_masks(EDGE_CENTRES, np.broadcast_to(xs, (n, 224)),
                                  np.broadcast_to(ys, (n, 224)))
    assert (x_fused != y_fused).any((1, 2)).all()
    jenv = jm.MobileRobotEnv(srl_model="raw_pixels")
    jstates = edge_centre_states(jax, jenv)
    expect = np.asarray(_jax_render(jenv)(jstates))
    out = render2d.render_mobile_robot(tm.MobileRobotEnv(srl_model="raw_pixels"),
                                       port_states(jstates)).numpy()
    np.testing.assert_array_equal(out, expect)
    yellow = (out == rr._color_u8(rr.TARGET_YELLOW)).all(-1)
    np.testing.assert_array_equal(yellow, x_fused)


@pytest.mark.parametrize("variant", ["MobileRobotEnv", "MobileRobot2TargetEnv",
                                     "MobileRobotLineTargetEnv"])
def test_twin_matches_pallas_interpret(jax_ref, variant):
    """The reference's own cases (tests/test_pallas_render.py:19-25)."""
    jax, jm, _ = jax_ref
    from srl_tpu.ops.pallas_render import render_mobile_robot_pallas

    jenv = getattr(jm, variant)(srl_model="raw_pixels")
    tenv = getattr(tm, variant)(srl_model="raw_pixels")
    jstates = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), 4))
    expect = np.asarray(render_mobile_robot_pallas(jenv, jstates))
    np.testing.assert_array_equal(
        render2d.render_mobile_robot(tenv, port_states(jstates)).numpy(), expect)


@pytest.mark.parametrize("variant", VARIANTS)
def test_fpv_matches_reference(jax_ref, variant):
    jax, jm, _ = jax_ref
    kwargs = dict(srl_model="raw_pixels", fpv=True, random_target=True,
                  render_shape=(64, 64))
    jenv, tenv = getattr(jm, variant)(**kwargs), getattr(tm, variant)(**kwargs)
    jstates = reference_states(jax, jenv, 4, seed=9, n_steps=5)
    expect = np.asarray(_jax_render(jenv)(jstates))
    out = render2d.render_mobile_robot(tenv, port_states(jstates)).numpy()
    assert out.shape == expect.shape == (4, 64, 64, 6)
    np.testing.assert_array_equal(out[..., :3], expect[..., :3])
    diff = np.abs(out[..., 3:].astype(np.int32) - expect[..., 3:].astype(np.int32))
    assert (diff == 0).mean() > 0.995 and (diff > 2).mean() < 0.005


def test_scene_rows_match_the_reference(jax_ref):
    jax, jm, _ = jax_ref
    from srl_tpu.ops.pallas_render import _scene_params

    for variant in VARIANTS:
        jenv = getattr(jm, variant)(random_target=True)
        tenv = getattr(tm, variant)(random_target=True)
        jstates = reference_states(jax, jenv, 4, seed=1, n_steps=3)
        np.testing.assert_array_equal(
            render2d.scene_params(tenv, port_states(jstates)).numpy(),
            np.asarray(_scene_params(jenv, jstates)))


def test_wrapper_refuses_cpu_tensors_for_the_kernel():
    env = tm.MobileRobotEnv(srl_model="raw_pixels", render_shape=(16, 16))
    scene = render2d.scene_params(env, env.reset(torch.Generator().manual_seed(0), 2))
    xs, ys, _ = render2d.static_tensors(env.dim, 16, 16, scene.device)
    bg_rgb = render2d.background_rgb(env.dim, 16, 16, scene.device)
    with pytest.raises(ValueError, match="CUDA tensor"):
        render2d.render_mobile_robot_cuda(scene, xs, ys, bg_rgb)


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("hw", [(224, 224), (30, 40), (30, 41)])
def test_background_bytes_are_the_packed_background(dim, hw):
    """The kernel's background, RGB bytes, holds the twin's packed words."""
    _, _, bg = render2d.static_tensors(dim, *hw, "cpu")
    rgb = render2d.background_rgb(dim, *hw, "cpu")
    assert rgb.dtype == torch.uint8 and rgb.shape == (*hw, 3) and rgb.is_contiguous()
    assert torch.equal(rgb.to(torch.int32), torch.stack([(bg >> s) & 255 for s in (0, 8, 16)], -1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fpv", [False, True])
def test_kernel_matches_twin_on_card(variant, fpv, cuda_device):
    env = getattr(tm, variant)(srl_model="raw_pixels", random_target=True, fpv=fpv)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    states = env.reset(gen, 64)
    for _ in range(20):
        states, _, _ = env.step(states, env.action_space.sample(gen, 64), gen)
    out = render2d.render_mobile_robot(env, states)
    scene = render2d.scene_params(env, states)
    plain = render2d.render_mobile_robot_plain(
        scene, *render2d.static_tensors(env.dim, 224, 224, cuda_device))
    torch.cuda.synchronize()
    assert out.shape == (64, 224, 224, 6 if fpv else 3)
    assert torch.equal(out[..., :3], plain)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(30, 40), (30, 41)])
@pytest.mark.parametrize("fpv", [False, True])
def test_kernel_matches_twin_on_card_at_a_ragged_shape(hw, fpv, cuda_device):
    """Pixel counts that are not a multiple of the kernel's 512-pixel span:
    1,200 (every env's output 16-byte aligned) and 1,230 (not)."""
    env = tm.MobileRobotEnv(srl_model="raw_pixels", random_target=True, fpv=fpv,
                            render_shape=hw)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    states = env.reset(gen, 64)
    for _ in range(20):
        states, _, _ = env.step(states, env.action_space.sample(gen, 64), gen)
    out = render2d.render_mobile_robot(env, states)
    plain = render2d.render_mobile_robot_plain(
        render2d.scene_params(env, states), *render2d.static_tensors(env.dim, *hw, cuda_device))
    torch.cuda.synchronize()
    assert out.shape == (64, *hw, 6 if fpv else 3)
    assert torch.equal(out[..., :3], plain)


if __name__ == "__main__":
    # Regenerate the edge centres, and show how the reference's XLA and
    # Pallas (interpret mode) compositors draw them.
    import jax

    from srl_tpu.envs import mobile_robot as jm
    from srl_tpu.ops.pallas_render import render_mobile_robot_pallas

    for seed in range(6):
        centres, searched = disk_edge_centres(3, seed)
        print(f"seed {seed}: {len(centres)} edge centres in {searched} searched: "
              f"{centres.tolist()}")
    jenv = jm.MobileRobotEnv(srl_model="raw_pixels")
    jstates = edge_centre_states(jax, jenv)
    xla = np.asarray(_jax_render(jenv)(jstates))
    pallas = np.asarray(render_mobile_robot_pallas(jenv, jstates))
    print("centres where Pallas (interpret) differs from XLA:",
          int((xla != pallas).any((1, 2, 3)).sum()), "of", len(EDGE_CENTRES))
