"""srl_tpu_torch.srl.nets and the SRL bridge against srl_tpu.srl.nets on the
CPU, with the reference's initial parameters carried over by
``bridge.srl_flax_to_state_dict``.

Tolerances:
* The conv encoder runs its convs in bfloat16 on both sides, but XLA and
  PyTorch round the bf16 products and the bias add differently: states
  agree within 1e-2 of their largest magnitude (measured about 5e-4).
* The decoder's outputs are sigmoids in [0, 1]: within 2e-3 (measured
  under 1e-5).
* The MLP encoder and the heads are float32 matmuls: 1e-5 relative.
* The bridge round trip (state_dict -> Flax -> state_dict) is exact, and
  the port's tree has the keys and shapes of a JAX init's.
* ``preprocessImage`` (a 224x224 frame in [-1, 1], resized with
  anti-aliasing when it shrinks): within 1e-4 (measured 2.4e-5 for
  240x320, 0.003 of a level of 255; without ``antialias`` the error is
  tens of levels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.srl import SRLType as JSRLType
from srl_tpu.srl import preprocessing as jpre
from srl_tpu.srl.nets import SRLModules as JModules
from srl_tpu.srl.nets import split_ranges as jsplit_ranges
from srl_tpu.srl.registry import registered_srl as jregistered
from srl_tpu_torch import bridge
from srl_tpu_torch.srl import registered_srl
from srl_tpu_torch.srl import nets
from srl_tpu_torch.srl import preprocessing as tpre
from srl_tpu_torch.srl.trainer import SRLTrainer

torch.set_num_threads(1)

BF16_SCALE_TOL = 1e-2
PREPROCESS_TOL = 1e-4
B = 2


def assert_close_to_scale(out, ref, tol=BF16_SCALE_TOL):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-6)


def jax_init(losses, obs_shape, state_dim=5, image_obs=True, n_actions=4, splits=()):
    """A reference ``SRLModules`` and its parameters, every head touched."""
    hw, c = (obs_shape[:2], obs_shape[2]) if image_obs else ((0, 0), 0)
    m = JModules(state_dim=state_dim, losses=tuple(losses), image_obs=image_obs,
                 obs_hw=hw, channels=c, n_actions=n_actions,
                 split_dimensions=tuple(splits))
    obs = jnp.zeros((B,) + tuple(obs_shape), jnp.uint8 if image_obs else jnp.float32)
    if "triplet" in losses:
        obs = obs[..., : obs_shape[-1] // 2]

    def touch(mdl, o):
        s, _ = mdl.vae_posterior(o) if "vae" in losses else (mdl.encode(o), None)
        if mdl._recon is not None:
            mdl.decode(s)
        if "forward" in losses:
            mdl.predict_forward(s, jnp.zeros((B, n_actions)))
        if "inverse" in losses:
            mdl.predict_inverse(s, s)
        if "reward" in losses:
            mdl.predict_reward(s, s)
        return s

    params = jax.jit(lambda k, o: m.init(k, o, method=touch))(jax.random.PRNGKey(0), obs)
    return m, jax.tree.map(np.asarray, params)


def port_modules(jparams, losses, obs_shape, state_dim=5, image_obs=True, n_actions=4,
                 splits=None):
    m = nets.SRLModules(state_dim, losses, obs_shape, image_obs, n_actions, splits)
    m.load_state_dict(bridge.srl_flax_to_state_dict(jparams))
    return m.eval()


@pytest.mark.parametrize("name", sorted(jregistered))
def test_registry_entry_and_split_ranges_match(name):
    ref, port = jregistered[name], registered_srl[name]
    assert port["type"].name == ref["type"].name
    assert (port["limited_to"], port["losses"], port["splits"]) == (
        ref["limited_to"], ref["losses"], ref["splits"])
    for state_dim in (8, 200):
        assert nets.split_ranges(port["losses"], state_dim, port["splits"] or None) == \
            jsplit_ranges(ref["losses"], state_dim, ref["splits"] or None)
    assert sorted(registered_srl) == sorted(jregistered)
    assert {t.name for t in JSRLType} == {"ENVIRONMENT", "SRL"}


def test_same_padding_is_flax_rule_at_224():
    assert [nets.same_padding(n, k, s) for n, k, s in ((224, 8, 4), (56, 4, 2), (28, 3, 2))
            ] == [(2, 2), (1, 1), (0, 1)]


@pytest.mark.parametrize("hw", [(64, 64), (40, 52), (224, 224)])
def test_conv_encoder_matches_in_bf16(hw):
    losses = ("autoencoder",)
    obs_shape = hw + (3,)
    jm, params = jax_init(losses, obs_shape)
    tm = port_modules(params, losses, obs_shape)
    obs = np.random.RandomState(0).randint(0, 256, (B,) + obs_shape).astype(np.uint8)
    ref = jax.jit(lambda p, o: jm.apply(p, o, method=JModules.encode))(params, obs)
    with torch.no_grad():
        out = tm.encode(torch.from_numpy(obs))
    assert out.dtype == torch.float32
    assert_close_to_scale(out, ref)


def test_mlp_encoder_matches():
    losses = ("inverse",)
    jm, params = jax_init(losses, (7,), image_obs=False)
    tm = port_modules(params, losses, (7,), image_obs=False)
    obs = np.random.RandomState(1).randn(B, 7).astype(np.float32)
    ref = np.asarray(jm.apply(params, obs, method=JModules.encode))
    with torch.no_grad():
        out = tm.encode(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 64), (8, 12)])
def test_decoder_matches(hw):
    """At 8x12 the decoder's 16x16 output is cropped to 8x12."""
    losses = ("autoencoder",)
    jm, params = jax_init(losses, hw + (3,))
    tm = port_modules(params, losses, hw + (3,))
    s = np.random.RandomState(2).randn(B, 5).astype(np.float32)
    ref = np.asarray(jm.apply(params, s, method=JModules.decode))
    with torch.no_grad():
        out = tm.decode(torch.from_numpy(s)).numpy()
    assert out.shape == (B,) + hw + (3,) == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-3)


def test_heads_and_vae_posterior_match():
    losses = ("vae", "forward", "inverse", "reward")
    splits = (("vae", -1), ("forward", 2), ("inverse", 2), ("reward", 2))
    jm, params = jax_init(losses, (32, 32, 3), state_dim=10, splits=splits)
    tm = port_modules(params, losses, (32, 32, 3), state_dim=10, splits=dict(splits))
    assert tm.ranges == jsplit_ranges(losses, 10, dict(splits))
    rng = np.random.RandomState(3)
    s, s2 = (rng.randn(B, 10).astype(np.float32) for _ in range(2))
    a = np.eye(4, dtype=np.float32)[[1, 3]]
    t = lambda x: torch.from_numpy(x)
    with torch.no_grad():
        for method, args in ((JModules.predict_forward, (s, a)),
                             (JModules.predict_inverse, (s, s2)),
                             (JModules.predict_reward, (s, s2))):
            ref = np.asarray(jm.apply(params, *args, method=method))
            out = getattr(tm, method.__name__)(*map(t, args)).numpy()
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6, err_msg=method.__name__)
        obs = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
        mu, log_var = jm.apply(params, obs, method=JModules.vae_posterior)
        tmu, tlog_var = tm.vae_posterior(t(obs))
    assert_close_to_scale(tmu, mu)
    assert_close_to_scale(tlog_var, log_var)


def test_split_heads_read_only_their_slice():
    """srl_splits: the inverse head reads only its slice, the decoder only
    the autoencoder's (tests/test_srl.py:210-225), and both agree with the
    reference."""
    entry = registered_srl["srl_splits"]
    losses, splits = tuple(entry["losses"]), tuple(entry["splits"].items())
    jm, params = jax_init(losses, (16, 16, 3), state_dim=8, splits=splits)
    tm = port_modules(params, losses, (16, 16, 3), state_dim=8, splits=entry["splits"])
    assert tm.ranges == {"autoencoder": (0, 4), "reward": (4, 6), "inverse": (6, 8)}
    s0 = torch.zeros((1, 8))
    s_ae, s_inv = s0.clone(), s0.clone()
    s_ae[0, 0] = 5.0
    s_inv[0, 6] = 5.0
    with torch.no_grad():
        inv = lambda s: tm.predict_inverse(s, s).numpy()
        dec = lambda s: tm.decode(s).numpy()
        np.testing.assert_allclose(inv(s0), inv(s_ae), atol=1e-6)
        assert not np.allclose(inv(s0), inv(s_inv))
        np.testing.assert_allclose(dec(s0), dec(s_inv), atol=1e-6)
        assert not np.allclose(dec(s0), dec(s_ae))
        for s in (s0, s_ae, s_inv):
            ref = jm.apply(params, s.numpy(), s.numpy(), method=JModules.predict_inverse)
            np.testing.assert_allclose(inv(s), np.asarray(ref), rtol=1e-5, atol=1e-6)
            ref = jm.apply(params, s.numpy(), method=JModules.decode)
            np.testing.assert_allclose(dec(s), np.asarray(ref), atol=2e-3)


@pytest.mark.parametrize("case", ["combination", "vae", "triplet_6ch", "mlp"])
def test_bridge_round_trip_and_tree_of_a_jax_init(case):
    kw = {
        "combination": dict(losses=("autoencoder", "inverse", "forward", "reward"),
                            obs_shape=(16, 16, 3)),
        "vae": dict(losses=("vae",), obs_shape=(16, 16, 3)),
        "triplet_6ch": dict(losses=("triplet",), obs_shape=(16, 16, 6)),
        "mlp": dict(losses=("inverse", "forward"), obs_shape=(5,), image_obs=False),
    }[case]
    _, params = jax_init(**kw)
    sd = bridge.srl_flax_to_state_dict(params)
    back = bridge.srl_state_dict_to_flax(sd)
    jax.tree.map(np.testing.assert_array_equal, params, back)
    again = bridge.srl_flax_to_state_dict(back)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    # A fresh port model (the trainer's seeded init) has the same tree.
    trainer = SRLTrainer(state_dim=5, losses=list(kw["losses"]), obs_shape=kw["obs_shape"],
                         image_obs=kw.get("image_obs", True), device="cpu")
    fresh = bridge.srl_state_dict_to_flax(trainer.params0)
    assert jax.tree.map(np.shape, fresh) == jax.tree.map(np.shape, params)


@pytest.mark.parametrize("hw", [(224, 224), (448, 448), (240, 320), (100, 150)])
def test_preprocess_image_matches_antialiased_resize(hw):
    """jax.image.resize's bilinear filter widens with the scale when it
    shrinks (anti-aliasing); F.interpolate(antialias=True) matches it."""
    img = np.random.RandomState(6).randint(0, 256, hw + (3,)).astype(np.uint8)
    ref = np.asarray(jpre.preprocessImage(img))
    out = tpre.preprocessImage(img).numpy()
    assert out.shape == ref.shape == (224, 224, 3)
    np.testing.assert_allclose(out, ref, atol=PREPROCESS_TOL)
    np.testing.assert_allclose(tpre.deNormalize(out).numpy(),
                               np.asarray(jpre.deNormalize(ref)), atol=PREPROCESS_TOL)
    assert tpre.getNChannels() == jpre.getNChannels() == 3
