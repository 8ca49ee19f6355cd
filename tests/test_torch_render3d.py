"""The port's Kuka ray tracer against the reference's Pallas kernel.

On the CPU the reference kernel runs in interpret mode (it picks that itself,
srl_tpu/ops/pallas_render3d.py:495) and the port runs its plain twin
``render_kuka_plain``. The two evaluate the same float32 formulas in the same
order, so the agreement asked for here is near-exact: at least 99.9% of the
values equal and at most 0.1% off by more than 2. The camera-static
constants (background planes, camera rays, scene table) match to 1e-6.

The kernel culls: it traces a primitive only at pixels inside the
rectangle that ``render3d.cull_rects`` computes in PyTorch. On the CPU,
every pixel that a primitive's own intersection (the twin's ``_hit_*``)
hits must lie inside its rectangle, on every configuration, for random arm
poses: then culling can change no pixel. The shaded background the kernel
stores where no primitive wins equals the twin's shade bit for bit.

The ``gpu`` tests hold the CUDA kernel against the twin on the card, with
the agreement metric of tests/test_pallas_render.py (99.5% equal, under 0.5%
off by more than 2: the kernel's fused multiply-adds move a few silhouette
pixels), at the shapes ``chip_smoke.py`` uses, and the culled kernel
bit-equal to its own launch with culling off.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from srl_tpu_torch import bridge
from srl_tpu_torch.envs import kuka as tk
from srl_tpu_torch.ops import kinematics as kin
from srl_tpu_torch.ops import render3d
from srl_tpu_torch.ops import renderer3d as r3

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
    cam = render3d.camera_tensors(cfg, scene.device)
    with pytest.raises(ValueError, match="CUDA tensor"):
        render3d.render_kuka_cuda(cfg, scene, cam)


def random_pose_scene(case, seed, n):
    """(cfg, scene) of ``n`` port envs reset from ``seed``, with the arm's
    joints drawn uniformly within their limits."""
    name, kwargs = CASES[case]
    env = getattr(tk, name)(srl_model="raw_pixels", **kwargs)
    states = env.reset(torch.Generator().manual_seed(seed), n)
    rng = np.random.default_rng(seed)
    states.q = torch.as_tensor(rng.uniform(kin.NULL_LL, kin.NULL_UL, (n, 7)), dtype=torch.float32)
    return render3d._scene_table(env, states)


def primitive_hits(cfg, scene, which):
    """bool [N, n_prim, P]: where each primitive's own intersection (the
    twin's helpers) hits, in the kernel's primitive order."""
    eye, *dirs = render3d._camera_planes(which, cfg.trace_h, cfg.trace_w)
    dx, dy, dz = (torch.as_tensor(d).reshape(-1) for d in dirs)
    col = lambda j: scene[:, j:j + 1]
    ts = []
    off = 3 * cfg.n_pts
    for i in range(cfg.n_buttons):
        bx, by = col(off + 2 * i), col(off + 2 * i + 1)
        ts.append(render3d._hit_vcylinder(eye, dx, dy, dz, bx, by, tk.BUTTON_BASE_RADIUS,
                                          tk.Z_TABLE, tk.BUTTON_BASE_TOP)[0])
        ts.append(render3d._hit_vcylinder(eye, dx, dy, dz, bx, by, tk.BUTTON_CAP_RADIUS,
                                          tk.BUTTON_BASE_TOP, tk.BUTTON_CAP_TOP)[0])
    pts = [(col(3 * i), col(3 * i + 1), col(3 * i + 2)) for i in range(cfg.n_pts)]
    n_seg = cfg.n_pts - 1
    for i in range(n_seg):
        radius = r3.ARM_LAST_RADIUS if i == n_seg - 1 else r3.ARM_LINK_RADIUS
        ts.append(render3d._hit_capsule_body(eye, dx, dy, dz, pts[i], pts[i + 1], radius)[0])
    for i in range(cfg.n_pts):
        radius = r3.ARM_LAST_RADIUS if i == cfg.n_pts - 1 else r3.ARM_LINK_RADIUS
        ts.append(render3d._hit_sphere(eye, dx, dy, dz, *pts[i], radius)[0])
    if cfg.n_distract:
        doff = off + 2 * cfg.n_buttons
        for i in range(cfg.n_distract + 1):
            radius = r3.BALL_RADIUS if i == cfg.n_distract else r3.DISTRACTOR_RADIUS
            k = doff + 3 * i
            ts.append(render3d._hit_sphere(eye, dx, dy, dz, col(k), col(k + 1), col(k + 2),
                                           radius)[0])
    return torch.stack(ts, 1) < render3d.BIG


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_cull_rects_hold_every_hit(case, seed):
    """Culling is exact: a primitive misses every pixel outside its
    rectangle, on both cameras, for random arm poses."""
    cfg, scene = random_pose_scene(case, seed, 4)
    assert len(render3d.primitive_kinds(cfg)) == len(render3d.cull_rects(cfg, scene, 0)[0])
    p = torch.arange(cfg.trace_h * cfg.trace_w)
    rows, cols = p // cfg.trace_w, p % cfg.trace_w
    for v, which in enumerate(cfg.views):
        hits = primitive_hits(cfg, scene, which)
        rect = render3d.cull_rects(cfg, scene, v)[..., None]
        inside = ((rows >= rect[..., 0, :]) & (rows <= rect[..., 1, :])
                  & (cols >= rect[..., 2, :]) & (cols <= rect[..., 3, :]))
        assert hits.any() and not (hits & ~inside).any()
        kept = render3d.kept_pixels(cfg, scene, v)
        assert torch.equal(kept, inside.sum(-1))
        # The rectangles keep a small part of the work.
        assert kept.sum() < 0.5 * inside.numel()


@pytest.mark.parametrize("which", ["main", "aux"])
def test_shaded_background_matches_twin(which):
    """The kernel's background colours are the twin's shade of
    _background_planes, bit for bit: the twin traced with no primitive."""
    cfg = render3d.RenderConfig(n_buttons=0, n_pts=0, n_distract=0, trace_h=32,
                                trace_w=40, up=1, views=(which,))
    cam = render3d.camera_tensors(cfg, "cpu")
    twin = render3d._trace_view_plain(cfg, torch.zeros(1, 0), cam.eyes[0], *cam.rays[0],
                                      cam.bg[0])[0].to(torch.int32)
    assert torch.equal(cam.bg_rgb[0].T.to(torch.int32), twin)


@pytest.mark.parametrize("which", ["main", "aux"])
def test_button_planes_are_the_twins_terms(which):
    """The per-pixel button terms the kernel reads hold the values the
    twin's _hit_vcylinder computes, bit for bit."""
    eye, *dirs = render3d._camera_planes(which, 32, 32)
    dx, dy, dz = (torch.as_tensor(d).reshape(-1) for d in dirs)
    planes = torch.as_tensor(render3d._button_planes(which, 32, 32))
    a = dx * dx + dy * dy
    assert torch.equal(planes[0], a) and torch.equal(planes[1], 2 * r3._safe(a))
    for k, z_hi in enumerate((tk.BUTTON_BASE_TOP, tk.BUTTON_CAP_TOP)):
        t = render3d._hit_floor(eye, dx, dy, dz, z_hi)
        assert torch.equal(planes[2 + 3 * k], t)
        # The twin's cap test: eye + t d - centre, rounded after the sum.
        cx = torch.tensor([[0.3], [0.55]])
        assert torch.equal((planes[3 + 3 * k] - cx), eye[0] + t * dx - cx)
        assert torch.equal((planes[4 + 3 * k] - cx), eye[1] + t * dy - cx)


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
    cam = render3d.camera_tensors(cfg, scene.device)
    out = render3d.render_kuka_cuda(cfg, scene, cam)
    plain = render3d.render_kuka_plain(cfg, scene, cam.eyes, cam.rays, cam.bg)
    torch.cuda.synchronize()
    assert out.shape == plain.shape == (n,) + tuple(env.observation_space.shape)
    equal, off = agreement(out.cpu().numpy(), plain.cpu().numpy())
    assert equal > 0.995 and off < 0.005


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_culled_kernel_equals_unculled_on_card(case, cuda_device):
    cls, kwargs, n = GPU_CASES[case]
    env = cls(srl_model="raw_pixels", **kwargs)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    states = env.reset(gen, n)
    for _ in range(10):
        states, _, _ = env.step(states, env.action_space.sample(gen, n), gen)
    cfg, scene = render3d._scene_table(env, states)
    cam = render3d.camera_tensors(cfg, scene.device)
    culled = render3d.render_kuka_cuda(cfg, scene, cam)
    unculled = render3d.render_kuka_cuda(cfg, scene, cam, cull=False)
    torch.cuda.synchronize()
    assert torch.equal(culled, unculled)
