"""The port's Kuka ray tracer against the reference's Pallas kernel.

On the CPU the reference kernel runs in interpret mode (it picks that itself,
srl_tpu/ops/pallas_render3d.py:495) and the port runs its plain twin
``render_kuka_plain``. The two evaluate the same float32 formulas in the same
order, so the agreement asked for here is near-exact: at least 99.9% of the
values equal and at most 0.1% off by more than 2. The camera-static
constants (background planes, camera rays, scene table) match to 1e-6.

The ``gpu`` tests hold the CUDA kernel against the twin on the card, with
the agreement metric of tests/test_pallas_render.py (99.5% equal, under 0.5%
off by more than 2: the kernel's fused multiply-adds move a few silhouette
pixels), at the shapes ``chip_smoke.py`` uses.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from srl_tpu_torch import bridge
from srl_tpu_torch.envs import kuka as tk
from srl_tpu_torch.ops import render3d

torch.set_num_threads(1)

# (env class name, kwargs): every render configuration of the slice.
CASES = {
    "button_s7": ("KukaButtonEnv", dict(render_scale=7)),
    "button_s2_coarse": ("KukaButtonEnv", dict(render_scale=2, coarse_obs=True)),
    "rand_s7": ("KukaRandButtonEnv", dict(render_scale=7)),
    "2button_s7": ("Kuka2ButtonEnv", dict(render_scale=7)),
    "multiview_s7": ("KukaButtonEnv", dict(render_scale=7, multi_view=True)),
}


@pytest.fixture(scope="module")
def ref():
    """The reference renderer, imported here and not at the top, so that the
    ``gpu`` tests also run where JAX is not installed."""
    pytest.importorskip("jax")
    from srl_tpu.ops import pallas_render3d

    return pallas_render3d


def agreement(a: np.ndarray, b: np.ndarray):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return float((diff == 0).mean()), float((diff > 2).mean())


@functools.lru_cache(maxsize=None)
def reference_case(case):
    """(reference env, port env, reference states, their arrays): 2 envs
    reset by the reference, shared by the tests of one configuration."""
    jax = pytest.importorskip("jax")
    from srl_tpu.envs import kuka

    name, kwargs = CASES[case]
    jenv = getattr(kuka, name)(srl_model="raw_pixels", **kwargs)
    tenv = getattr(tk, name)(srl_model="raw_pixels", **kwargs)
    jstates = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(11), 2))
    arrays = {f.name: np.asarray(getattr(jstates, f.name))
              for f in dataclasses.fields(jstates)}
    return jenv, tenv, jstates, arrays


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_pallas_interpret(ref, case):
    jenv, tenv, jstates, arrays = reference_case(case)
    expect = np.asarray(ref.render_kuka_pallas(jenv, jstates))
    out = render3d.render_kuka(tenv, bridge.kuka_state_from_numpy(arrays)).numpy()
    assert out.shape == expect.shape == (2,) + tuple(tenv.observation_space.shape)
    assert out.dtype == np.uint8
    equal, off = agreement(out, expect)
    print(f"{case}: {equal:.6f} equal, {off:.6f} off by more than 2")
    assert equal >= 0.999 and off <= 0.001


@pytest.mark.parametrize("which", ["main", "aux"])
def test_camera_constants_match(ref, which):
    jpr = ref
    h = w = 32
    np.testing.assert_allclose(render3d._background_planes(which, h, w),
                               jpr._background_planes(which, h, w), atol=1e-6, rtol=0)
    eye, dx, dy, dz = render3d._camera_planes(which, h, w)
    jeye, jdx, jdy, jdz, _ = jpr._camera_planes(which, h, w)
    np.testing.assert_allclose(eye, jeye, atol=1e-6, rtol=0)
    for a, b in ((dx, jdx), (dy, jdy), (dz, jdz)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["button_s7", "rand_s7", "2button_s7"])
def test_scene_table_matches(ref, case):
    jenv, tenv, jstates, arrays = reference_case(case)
    jcfg, jscene = ref._scene_table(jenv, jstates)
    cfg, scene = render3d._scene_table(tenv, bridge.kuka_state_from_numpy(arrays))
    np.testing.assert_allclose(scene.numpy(), np.asarray(jscene), atol=1e-6, rtol=0)
    assert (cfg.n_buttons, cfg.n_pts, cfg.n_distract) == jcfg[:3]


def test_cpu_wrapper_refuses_cpu_tensors_for_the_kernel():
    env = tk.KukaButtonEnv(render_scale=7)
    cfg, scene = render3d._scene_table(env, env.reset(torch.Generator().manual_seed(0), 2))
    eyes, rays, bg = render3d.camera_tensors(cfg, scene.device)
    with pytest.raises(ValueError, match="CUDA tensor"):
        render3d.render_kuka_cuda(cfg, scene, eyes, rays, bg)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# The configurations chip_smoke.py checks: (port env, kwargs, N).
GPU_CASES = {
    "button_s1": (tk.KukaButtonEnv, dict(render_scale=1), 64),
    "button_s2_coarse": (tk.KukaButtonEnv, dict(render_scale=2, coarse_obs=True), 256),
    "rand_s1": (tk.KukaRandButtonEnv, dict(render_scale=1), 64),
    "2button_s1": (tk.Kuka2ButtonEnv, dict(render_scale=1), 64),
    "multiview_s2": (tk.KukaButtonEnv, dict(render_scale=2, multi_view=True), 64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_kernel_matches_twin_on_card(case, cuda_device):
    cls, kwargs, n = GPU_CASES[case]
    env = cls(srl_model="raw_pixels", **kwargs)
    states = env.reset(torch.Generator(device=cuda_device).manual_seed(0), n)
    cfg, scene = render3d._scene_table(env, states)
    eyes, rays, bg = render3d.camera_tensors(cfg, scene.device)
    out = render3d.render_kuka_cuda(cfg, scene, eyes, rays, bg)
    plain = render3d.render_kuka_plain(cfg, scene, eyes, rays, bg)
    torch.cuda.synchronize()
    assert out.shape == plain.shape == (n,) + tuple(env.observation_space.shape)
    equal, off = agreement(out.cpu().numpy(), plain.cpu().numpy())
    assert equal > 0.995 and off < 0.005
