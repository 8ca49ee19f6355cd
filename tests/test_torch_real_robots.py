"""srl_tpu_torch.real_robots and srl_tpu_torch.srl.{server, client} against
srl_tpu on the CPU.

One counterpart of each case of tests/test_real_robots.py, run against the
port, and the cases across the packages: a port client against a reference
server and the other way round, on the reference's wire format (a JSON
metadata frame, then the raw buffer). The port's Omnirobot simulator
server, fed the random numbers the reference's server draws from its keys,
sends the same JSON states and frames, bit for bit. The marker finder, the
target finder, the connected components and the homography are the
reference's numpy, so they give equal arrays on the same seeded images.

No case can block for ever: every receive has a ``poll`` deadline, or runs
in a daemon thread joined with a timeout (``within``), every server thread
must stop within 5 s of EXIT, and no ZMQ context is collected while a
thread may still block on it (``keep_contexts``). Ports come from
``_free_port``.
"""
import os
import threading

import jax
import numpy as np
import pytest
import torch
import zmq

from srl_tpu.real_robots import constants as JC
from srl_tpu.real_robots import marker_finder as jmf
from srl_tpu.real_robots import remote_env as jremote
from srl_tpu.real_robots import ros_servers as jros
from srl_tpu.real_robots import sim_server as jsim
from srl_tpu.real_robots import transport as jtransport
from srl_tpu.srl import client as jclient
from srl_tpu.srl import server as jserver
from srl_tpu_torch.envs.omnirobot import INIT_MAX, INIT_MIN, TARGET_MAX, TARGET_MIN
from srl_tpu_torch.envs.omnirobot import OmniRobotEnv
from srl_tpu_torch.real_robots import constants as C
from srl_tpu_torch.real_robots import marker_finder as mf
from srl_tpu_torch.real_robots import remote_env, ros_servers, sim_server, transport
from srl_tpu_torch.srl import client, server

torch.set_num_threads(1)

TIMEOUT = 30.0  # seconds any client-side exchange may take


# Every ZMQ context a case makes. A context that is garbage-collected
# terminates, and terminating waits for its sockets: after a failed case a
# server thread may still block on one, so none is ever collected.
_CONTEXTS = []


@pytest.fixture(autouse=True)
def keep_contexts(monkeypatch):
    socket = zmq.Context.socket

    def recording(ctx, *args, **kwargs):
        _CONTEXTS.append(ctx)
        return socket(ctx, *args, **kwargs)

    monkeypatch.setattr(zmq.Context, "socket", recording)


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def within(seconds, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` in a daemon thread; fails the test if it has
    not returned after ``seconds``, re-raises what it raised."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(seconds)
    if thread.is_alive():
        pytest.fail(f"{getattr(fn, '__name__', fn)} did not return within {seconds} s")
    if "error" in out:
        raise out["error"]
    return out.get("value")


def serving(target, *args, **kwargs) -> threading.Thread:
    thread = threading.Thread(target=target, args=args, kwargs=kwargs, daemon=True)
    thread.start()
    return thread


def assert_stops(thread, seconds=5.0):
    thread.join(seconds)
    assert not thread.is_alive(), "the server did not stop after EXIT"


def received(socket, recv):
    assert socket.poll(int(TIMEOUT * 1000)), "nothing arrived before the deadline"
    return recv(socket)


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sender, receiver", [(transport, transport), (transport, jtransport),
                                              (jtransport, transport)],
                         ids=["port-port", "port-to-reference", "reference-to-port"])
def test_matrix_transport_roundtrip(sender, receiver):
    port = _free_port()
    _, srv = sender.connect_pair(port, server=True)
    _, cli = receiver.connect_pair(port)
    try:
        mats = [np.arange(24, dtype=np.uint8).reshape(2, 3, 4),
                np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32),
                np.arange(6, dtype=np.int64)[::2], np.eye(3, dtype=bool)]
        for mat in mats:
            sender.sendMatrix(srv, mat)
            out = received(cli, receiver.recvMatrix)
            assert out.dtype == mat.dtype and out.shape == mat.shape
            np.testing.assert_array_equal(out, mat)
    finally:
        srv.close()
        cli.close()


def test_action_table():
    actions = transport.getActions(0.05, 6)
    assert actions.shape == (6, 3)
    assert (np.abs(actions).sum(axis=1) <= 0.05 + 1e-9).all()
    for delta in (0.05, 0.02):
        np.testing.assert_array_equal(transport.getActions(delta, 6),
                                      jtransport.getActions(delta, 6))
    with pytest.raises(AssertionError, match="Wrong number of actions"):
        transport.getActions(0.05, 5)


# ---------------------------------------------------------------------------
# The Omnirobot simulator server
# ---------------------------------------------------------------------------

def episode(env, actions):
    """reset, then each action: [(obs, reward, done, position, target)]."""
    out = [(env.reset(), 0.0, False, env.getGroundTruth(), env.getTargetPos())]
    for a in actions:
        obs, reward, done, _ = env.step(a)
        out.append((obs, reward, done, env.getGroundTruth(), env.getTargetPos()))
    return out


def test_omnirobot_sim_server_protocol():
    """A client/server episode over ZMQ with the port's env behind the
    server, each message equal to the env stepped in process from the same
    generator seed."""
    port = _free_port()
    server_ = sim_server.OmniRobotSimServer(port=port, seed=5, device="cpu")
    thread = serving(server_.serve_forever)
    env = within(TIMEOUT, remote_env.OmniRobotRemoteEnv, port=port, srl_model="raw_pixels")
    actions = [i % 4 for i in range(5)]
    got = within(TIMEOUT, episode, env, actions)
    assert got[0][0].shape == (224, 224, 3) and got[0][0].dtype == np.uint8
    assert env.getGroundTruth().shape == (2,) and env.getTargetPos().shape == (2,)
    within(TIMEOUT, env.close)
    assert_stops(thread)

    local = OmniRobotEnv(srl_model="raw_pixels")
    gen = torch.Generator().manual_seed(5)
    state = local.reset(gen, 1)
    rewards = [0.0]
    frames = [local.render_pixels(state)[0].numpy()]
    for a in actions:
        state, reward, _ = local.step(state, torch.tensor([a], dtype=torch.int32), gen)
        rewards.append(float(reward[0]))
        frames.append(local.render_pixels(state)[0].numpy())
    for (obs, reward, done, pos, target), frame, r in zip(got, frames, rewards):
        np.testing.assert_array_equal(obs, frame)
        assert reward == r and not done
    np.testing.assert_array_equal(got[-1][3], state.robot_pos[0].numpy())
    np.testing.assert_array_equal(got[-1][4], state.target_pos[0].numpy())


def render_normals(key, count):
    """The render noise the reference's Omnirobot state with ``key`` draws
    at ``count`` (srl_tpu/envs/omnirobot.py, render_pixels)."""
    k1, k2 = jax.random.split(jax.random.fold_in(key, count))
    return jax.numpy.concatenate([jax.random.normal(k1, (2,)), jax.random.normal(k2, (1,))])


def reference_draws(seed: int, n_steps: int, noise: bool) -> list:
    """The random numbers the reference's server, from PRNGKey(seed), draws
    for a reset and ``n_steps`` steps, in the port's noise dicts."""
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    skey, k_robot, k_target = jax.random.split(sub, 3)
    uniform = lambda k, lo, hi: np.asarray(
        jax.random.uniform(k, (2,), minval=lo, maxval=hi, dtype=jax.numpy.float32))[None]
    draws = [{"robot_pos": uniform(k_robot, INIT_MIN, INIT_MAX),
              "target_pos": uniform(k_target, TARGET_MIN, TARGET_MAX)}]
    # A state's key after a reset, then after each step (srl_tpu's step
    # keeps the first half of a split); its step count is the index.
    keys = [skey]
    for _ in range(n_steps):
        keys.append(jax.random.split(keys[-1])[0])
        draws.append({})
    if noise:
        for count, (d, k) in enumerate(zip(draws, keys)):
            d["render"] = np.asarray(render_normals(k, count))[None]
    return [{k: torch.from_numpy(np.array(v)) for k, v in d.items()} for d in draws]


@pytest.mark.parametrize("noise", [True, False], ids=["noise", "no-noise"])
def test_sim_servers_agree_across_packages(noise):
    """A port client against the reference's server, and the reference's
    client against the port's server fed the reference's draws: the same
    frames, rewards and positions, bit for bit, wall bumps included."""
    seed, n_steps = 3, 30
    actions = np.random.default_rng(seed).integers(0, 4, n_steps).tolist()
    actions[:17] = [0] * 17  # +x into the wall from any start

    runs = {}
    for name, make_server, client_mod in (
            ("reference server", lambda p: jsim.OmniRobotSimServer(p, seed, noise=noise),
             remote_env),
            ("port server", lambda p: sim_server.OmniRobotSimServer(
                p, seed, noise=noise, device="cpu",
                env_draws=reference_draws(seed, n_steps, noise)), jremote)):
        port = _free_port()
        thread = serving(make_server(port).serve_forever)
        env = within(TIMEOUT, client_mod.OmniRobotRemoteEnv, port=port)
        runs[name] = within(TIMEOUT, episode, env, actions)
        within(TIMEOUT, env.close)
        assert_stops(thread)

    ref, port_ = runs["reference server"], runs["port server"]
    assert any(r == -1.0 for _, r, _, _, _ in ref), "no wall bump in the episode"
    for t, (a, b) in enumerate(zip(ref, port_)):
        for what, x, y in zip(("frame", "reward", "done", "position", "target"), a, b):
            np.testing.assert_array_equal(x, y, err_msg=f"step {t}: {what}")


# ---------------------------------------------------------------------------
# The SRL service
# ---------------------------------------------------------------------------

def test_srl_client_server_protocol(tmp_path):
    """HELLO / LEARN / READY against the port's trainer (2 episodes of 8
    steps), the checkpoint served through SRLEncodedEnv; a LEARN on a
    missing folder answers ERROR and the server still answers HELLO."""
    from srl_tpu_torch.data.dataset_generator import generate_dataset
    from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv
    from srl_tpu_torch.srl.models import SRLEncodedEnv, loadSRLModel

    folder = generate_dataset("MobileRobotGymEnv-v0", 2, save_path=str(tmp_path), name="d",
                              num_envs=2, max_steps=8, device="cpu")
    port = _free_port()
    thread = serving(server.serve, port, device="cpu")
    cli = within(TIMEOUT, client.SRLClient, folder, port=port)
    cli.sendLearnSignal("autoencoder", state_dim=2, epochs=1)
    ok, path = cli.waitForSRLModel(timeout_s=120)
    assert ok and os.path.isfile(path)
    encoded = SRLEncodedEnv(MobileRobotEnv(srl_model="raw_pixels"),
                            loadSRLModel(path, device="cpu"))
    obs = encoded.observe(encoded.reset(torch.Generator().manual_seed(0), 4))
    assert obs.shape == (4, 2) and torch.isfinite(obs).all()

    cli.data_folder = str(tmp_path / "missing")
    cli.sendLearnSignal("autoencoder", state_dim=2, epochs=1)
    assert cli.waitForSRLModel(timeout_s=TIMEOUT) == (False, None)
    within(TIMEOUT, cli.waitReady)
    cli.close()
    assert_stops(thread)


@pytest.mark.parametrize("serve, client_mod", [(jserver.serve, client),
                                               (server.serve, jclient)],
                         ids=["port-client-reference-server", "reference-client-port-server"])
def test_srl_service_across_packages(tmp_path, serve, client_mod):
    """HELLO, a LEARN that fails (ERROR), HELLO again and EXIT between the
    packages (no encoder is trained)."""
    port = _free_port()
    kwargs = {"device": "cpu"} if serve is server.serve else {}
    thread = serving(serve, port, **kwargs)
    cli = within(TIMEOUT, client_mod.SRLClient, str(tmp_path / "missing"), port=port)
    cli.sendLearnSignal("autoencoder", state_dim=2, epochs=1)
    assert cli.waitForSRLModel(timeout_s=TIMEOUT) == (False, None)
    within(TIMEOUT, cli.waitReady)
    cli.close()
    assert_stops(thread)
    assert client.Command.LEARN.value == jclient.Command.LEARN.value
    assert [c.name for c in client.Command] == [c.name for c in jclient.Command]
    assert client.SRL_SERVER_PORT == jclient.SRL_SERVER_PORT


# ---------------------------------------------------------------------------
# ROS servers and constants
# ---------------------------------------------------------------------------

def test_ros_servers_importable_without_ros():
    with pytest.raises(ImportError):
        import rospy  # noqa: F401
    assert ros_servers._require_ros() is False
    public = lambda m: {n for n in vars(m) if not n.startswith("_")}
    missing = public(jros) - public(ros_servers)
    assert not missing, missing
    for name in ("OmnirobotServer", "BaxterServer", "RoboboServer", "GazeboBaxterServer",
                 "RealBaxterServer", "change_coordinate_system", "find_target"):
        assert hasattr(ros_servers, name)


def test_remote_env_constants():
    assert C.Omnirobot.MAX_STEPS == 250
    assert C.Omnirobot.DIST_TO_TARGET_THRESHOLD == 0.2
    assert C.RealBaxter.DELTA_POS == 0.02
    assert C.BaxterGazebo.MAX_DISTANCE == 0.35
    for name, value in vars(JC).items():
        if name.startswith("_") or name in ("np", "os", "Enum", "annotations"):
            continue
        ported = getattr(C, name)
        if isinstance(value, type):
            for k, v in vars(value).items():
                if not k.startswith("_"):
                    w = getattr(ported, k)
                    if isinstance(v, type):  # the Move enum
                        assert [(m.name, m.value) for m in v] == [(m.name, m.value) for m in w]
                    else:
                        np.testing.assert_array_equal(w, v, err_msg=f"{name}.{k}")
        else:
            assert ported == value, name


# ---------------------------------------------------------------------------
# Marker finder (fiducial detection + planar pose)
# ---------------------------------------------------------------------------

def _make_tag(code, cell=10):
    return np.where(np.kron(code, np.ones((cell, cell))) > 0, 0.0, 255.0)


def _demo_code():
    code = np.zeros((9, 9), np.uint8)
    code[0, :] = code[-1, :] = code[:, 0] = code[:, -1] = 1
    code[2, 2] = code[2, 3] = code[3, 2] = 1
    code[5, 4] = code[6, 6] = code[4, 6] = 1
    return code


def _project_tag(tag_img, K, R, t, length, out_shape=(480, 640)):
    half = length / 2.0
    n = tag_img.shape[0]
    S = np.array([[length / n, 0, -half], [0, length / n, -half], [0, 0, 1.0]])
    P = K @ np.stack([R[:, 0], R[:, 1], t], axis=1)
    H = P @ S
    pad = n // 3
    padded = np.full((n + 2 * pad, n + 2 * pad), 255.0)
    padded[pad:pad + n, pad:pad + n] = tag_img
    shift = np.array([[1, 0, pad], [0, 1, pad], [0, 0, 1.0]])
    return mf.warp_perspective(padded, H @ np.linalg.inv(shift), out_shape)


def _rot(yaw, pitch):
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    return Ry @ Rz


CAMERA_INFO = """image_width: 640
image_height: 480
camera_name: head_camera
camera_matrix:
  rows: 3
  cols: 3
  data: [500.0, 0.0, 320.0,
         0.0, 500.0, 240.0,
         0.0, 0.0, 1.0]
distortion_model: plumb_bob
distortion_coefficients:
  rows: 1
  cols: 5
  data: [0.0, 0.0, 0.0, 0.0, 0.0]
"""


def test_marker_finder_detects_pose(tmp_path):
    """The tag's pose is recovered from its rendering, as in the reference,
    and the reference's finder gives the same pose (to 1e-6) and corners
    on the same image; a ``camera_info`` file gives both finders the same
    intrinsics."""
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    code = _demo_code()
    length = 0.2
    R = _rot(yaw=0.3, pitch=0.15)
    t = np.array([0.05, -0.03, 1.0])
    img = _project_tag(_make_tag(code), K, R, t, length)

    info = tmp_path / "camera.yaml"
    info.write_text(CAMERA_INFO)
    finders = {}
    for name, module, arg in (("port", mf, str(info)), ("reference", jmf, str(info)),
                              ("port dict", mf, {"camera_matrix": K})):
        finder = module.MakerFinder(arg)
        np.testing.assert_array_equal(finder.camera_matrix, K)
        np.testing.assert_array_equal(finder.distortion_coefficients, np.zeros(5))
        finder.setMarkerCode("robot", code, length)
        finders[name] = finder.findMarker(img, "robot")
    result = finders["port"]
    assert result is not None, "marker not detected"
    rot_vec, trans_vec, corners = result
    np.testing.assert_allclose(trans_vec, t, atol=0.02)
    theta = np.linalg.norm(rot_vec)
    k = rot_vec / (theta + 1e-12)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R_rec = np.eye(3) + np.sin(theta) * Kx + (1 - np.cos(theta)) * Kx @ Kx
    assert np.linalg.norm(R_rec - R) < 0.15, np.linalg.norm(R_rec - R)
    half = length / 2
    obj = np.array([[-half, -half, 0], [-half, half, 0], [half, half, 0], [half, -half, 0]])
    proj = (K @ (R @ obj.T + t[:, None])).T
    proj = proj[:, :2] / proj[:, 2:3]
    assert np.abs(np.sort(corners, axis=0) - np.sort(proj, axis=0)).max() < 3.0
    for other in ("reference", "port dict"):
        ref_rot, ref_trans, ref_corners = finders[other]
        np.testing.assert_allclose(rot_vec, ref_rot, rtol=0, atol=1e-6)
        np.testing.assert_allclose(trans_vec, ref_trans, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(corners, ref_corners)


def test_marker_finder_rejects_unknown_code():
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    code = _demo_code()
    other = _demo_code()
    other[2:7, 2:7] = 1 - other[2:7, 2:7]
    img = _project_tag(_make_tag(other), K, _rot(0.2, 0.1), np.array([0.0, 0.0, 1.2]), 0.2)
    finder = mf.MakerFinder({"camera_matrix": K})
    finder.setMarkerCode("robot", code, 0.2)
    assert finder.findMarker(img, "robot") is None


@pytest.mark.parametrize("seed", [0, 1])
def test_vision_helpers_equal_the_reference(seed):
    """label_components, find_target, homography_dlt and findMarker on
    seeded random images: equal arrays, the pose to 1e-6."""
    rng = np.random.default_rng(seed)
    binary = (rng.random((40, 56)) < 0.45).astype(np.uint8)
    labels, n = mf.label_components(binary)
    ref_labels, ref_n = jmf.label_components(binary)
    assert n == ref_n and n > 1
    np.testing.assert_array_equal(labels, ref_labels)

    img = rng.integers(0, 256, (96, 96, 3)).astype(np.uint8)
    img[20:60, 30:70] = rng.choice([(255, 0, 60), (230, 20, 40)], (40, 40))
    assert ros_servers.find_target(img) == jros.find_target(img)
    assert ros_servers.find_target(img)[3] is False

    src = rng.uniform(0, 100, (6, 2))
    dst = rng.uniform(0, 100, (6, 2))
    np.testing.assert_array_equal(mf.homography_dlt(src, dst), jmf.homography_dlt(src, dst))

    K = np.array([[450.0, 0, 250], [0, 460.0, 175], [0, 0, 1]])
    R = _rot(yaw=rng.uniform(-0.5, 0.5), pitch=rng.uniform(-0.2, 0.2))
    t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), rng.uniform(0.9, 1.3)])
    scene = _project_tag(_make_tag(_demo_code()), K, R, t, 0.2, out_shape=(360, 480))
    dist = np.array([0.01, -0.02, 0.001, 0.0, 0.0])
    poses = []
    for module in (mf, jmf):
        finder = module.MakerFinder({"camera_matrix": K, "distortion_coefficients": dist})
        finder.setMarkerCode("robot", _demo_code(), 0.2)
        poses.append(finder.findMarker(scene, "robot"))
    assert poses[0] is not None
    for a, b in zip(*poses):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Per-robot servers
# ---------------------------------------------------------------------------

class _FakeRoboboRig:
    """Records actuation commands; yaw follows the target perfectly."""

    def __init__(self):
        self.commands = []
        self._yaw = 0.0

    def move(self, t, speed):
        self.commands.append(("move", round(t, 4), speed))

    def turn(self, t, speed):
        self.commands.append(("turn", round(t, 4), speed))
        self._yaw += 90.0 if speed < 0 else -90.0

    def stop(self):
        self.commands.append(("stop",))

    def yaw(self):
        return self._yaw

    def sleep(self, seconds):
        pass


def test_robobo_motion_grid_and_timing():
    rig = _FakeRoboboRig()
    m = ros_servers.RoboboMotion(rig)
    m.init_yaw_north()
    assert abs(m.compute_time("left") - 2.04) < 1e-9
    assert m.apply_move(0) is False
    assert m.position == [0, 1]
    assert ("move", 1.7, 10) in rig.commands
    rig.commands.clear()
    assert m.apply_move(3) is False
    assert m.position == [1, 1]
    assert [c[0] for c in rig.commands] == ["turn", "move", "turn"]
    assert m.current_face_idx == 1
    m.position = [C.Robobo.MAX_X, 0]
    assert m.apply_move(3) is True
    assert m.position == [C.Robobo.MAX_X, 0]
    m.position = [0, C.Robobo.MIN_Y]
    assert m.apply_move(1) is True
    # The reference's state machine gives the same commands and positions.
    rigs = (_FakeRoboboRig(), _FakeRoboboRig())
    motions = (ros_servers.RoboboMotion(rigs[0]), jros.RoboboMotion(rigs[1]))
    for motion in motions:
        motion.init_yaw_north()
    for move in np.random.default_rng(0).integers(0, 5, 40):
        assert motions[0].apply_move(int(move)) == motions[1].apply_move(int(move))
        assert motions[0].position == motions[1].position
        assert motions[0].yaw_error == motions[1].yaw_error
    assert rigs[0].commands == rigs[1].commands


def _target_image(size=64, blob=12):
    img = np.zeros((size, size, 3), np.uint8)
    img[..., :] = (40, 40, 40)
    img[10:10 + blob, 20:20 + blob] = (255, 0, 60)
    return img


def test_find_target_centroid_and_area():
    cx, cy, area, error = ros_servers.find_target(_target_image())
    assert not error
    assert abs(cx - 25) <= 3 and abs(cy - 15) <= 3
    assert area > 0
    _, _, area0, error0 = ros_servers.find_target(np.zeros((64, 64, 3), np.uint8))
    assert error0 and area0 == 0.0
    for size, blob in ((64, 12), (224, 80), (224, 20)):
        img = _target_image(size, blob)
        assert ros_servers.find_target(img) == jros.find_target(img)
        np.testing.assert_array_equal(ros_servers.rgb_to_hsv_u8(img), jros.rgb_to_hsv_u8(img))


def test_robobo_server_loopback():
    """A full episode against the RoboboServer over a real socket: +1 when
    the target's area shrinks by MIN_DELTA_AREA, -1 on a grid bump."""
    full = _target_image(size=224, blob=80)
    img_holder = {"img": full}
    _, _, full_area, _ = ros_servers.find_target(full)
    old_area = C.Robobo.TARGET_INITIAL_AREA
    C.Robobo.TARGET_INITIAL_AREA = full_area
    try:
        port = _free_port()
        srv = ros_servers.RoboboServer(port, rig=_FakeRoboboRig(),
                                       get_image=lambda: img_holder["img"])
        thread = serving(srv.serve_forever)
        env = within(TIMEOUT, remote_env.RoboboEnv, port=port, srl_model="raw_pixels")
        obs = within(TIMEOUT, env.reset)
        assert obs.shape == (224, 224, 3)
        obs, reward, done, _ = within(TIMEOUT, env.step, 0)
        assert reward == 0
        np.testing.assert_array_equal(env.getGroundTruth(), [0, 1])
        img_holder["img"] = _target_image(size=224, blob=20)
        obs, reward, done, _ = within(TIMEOUT, env.step, 0)
        assert reward == 1
        srv.motion.position = [0, C.Robobo.MAX_Y]
        obs, reward, done, _ = within(TIMEOUT, env.step, 0)
        assert reward == -1
        within(TIMEOUT, env.close)
        assert_stops(thread)
    finally:
        C.Robobo.TARGET_INITIAL_AREA = old_area


class _FakeBaxterRig:
    """IK succeeds only inside a workspace sphere; tracks the button."""

    def __init__(self, cfg, button_pressed=False):
        self.cfg = cfg
        self._ee = np.array(cfg.LEFT_ARM_INIT_POS, np.float64)
        self._pressed = button_pressed
        self.enabled = False

    def ee_position(self):
        return self._ee.copy()

    def ik_move(self, position):
        if np.linalg.norm(position) > 2.0:
            return False
        self._ee = np.asarray(position, np.float64)
        return True

    def init_pose(self):
        self._ee = np.array(self.cfg.LEFT_ARM_INIT_POS, np.float64)

    def enable(self):
        self.enabled = True

    def button_pressed(self):
        return self._pressed

    def button_position(self):
        return np.array([0.6, 0.3, -0.14])

    def base_pose(self):
        return np.array([0.0, 0.0, -0.1]), np.array([0.0, 0.0, 0.0, 1.0])

    def image(self):
        return np.zeros((224, 224, 3), np.uint8)


def test_gazebo_vs_real_baxter_servers():
    """Gazebo's reward is the simulated button, its button position in the
    base frame; the real Baxter's reward is the distance to the calibrated
    button, and its reset enables the robot."""
    s = np.sin(np.pi / 4)
    quat = [0.0, 0.0, s, np.cos(np.pi / 4)]
    rel = ros_servers.change_coordinate_system([1.0, 0.0, 0.0], [0.0, 0.0, 0.0], quat)
    np.testing.assert_allclose(rel, [0.0, -1.0, 0.0], atol=1e-12)
    np.testing.assert_array_equal(
        rel, jros.change_coordinate_system([1.0, 0.0, 0.0], [0.0, 0.0, 0.0], quat))

    port = _free_port()
    rig = _FakeBaxterRig(C.BaxterGazebo, button_pressed=True)
    thread = serving(ros_servers.GazeboBaxterServer(port, rig=rig).serve_forever)
    env = within(TIMEOUT, remote_env.BaxterEnv, port=port, srl_model="raw_pixels", real=False)
    within(TIMEOUT, env.reset)
    obs, reward, done, _ = within(TIMEOUT, env.step, 0)
    assert reward >= 1
    expected = ros_servers.change_coordinate_system(rig.button_position(), *rig.base_pose())
    np.testing.assert_allclose(env.getTargetPos(), expected, atol=1e-6)
    within(TIMEOUT, env.close)
    assert_stops(thread)

    port = _free_port()
    rig = _FakeBaxterRig(C.RealBaxter)
    thread = serving(ros_servers.RealBaxterServer(port, rig=rig).serve_forever)
    env = within(TIMEOUT, remote_env.BaxterEnv, port=port, srl_model="raw_pixels", real=True)
    within(TIMEOUT, env.reset)
    assert rig.enabled
    obs, reward, done, _ = within(TIMEOUT, env.step, 0)
    assert reward < 1  # about 0.196 m from BUTTON_POS
    rig._ee = np.array(C.RealBaxter.BUTTON_POS) + 0.01
    obs, reward, done, _ = within(TIMEOUT, env.step, 0)
    assert reward >= 1
    within(TIMEOUT, env.close)
    assert_stops(thread)


def test_baxter_ik_failure_keeps_position():
    class _Srv(ros_servers.GazeboBaxterServer):
        def __init__(self, rig):  # no socket
            self.rig = rig
            self.cfg = C.BaxterGazebo

    rig = _FakeBaxterRig(C.BaxterGazebo)
    srv = _Srv(rig)
    before = rig.ee_position()
    state, _ = srv.handle({"command": "action", "action": [100.0, 0, 0]})
    np.testing.assert_array_equal(rig.ee_position(), before)
    np.testing.assert_allclose(state["position"], before)
