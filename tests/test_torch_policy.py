"""srl_tpu_torch.models against srl_tpu.models on the CPU, with the reference
parameters carried over by srl_tpu_torch.bridge.

Tolerances: the float32 MLP actor-critic at rtol 1e-5 (atol 1e-6); the Nature
CNN runs its convs and fc512 in bfloat16 in both packages, which round at
different places (accumulation order, where the bias is added), so its
logits and values must agree within 2e-2 of their scale (max |reference|);
the conv1 fold identity in float32 at atol 1e-5; distributions at 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from srl_tpu.core import spaces as jspaces
from srl_tpu.models import distributions as jdist
from srl_tpu.models import policies as jpol
from srl_tpu_torch import bridge
from srl_tpu_torch.core import spaces as tspaces
from srl_tpu_torch.models import distributions as tdist
from srl_tpu_torch.models import policies as tpol

torch.set_num_threads(1)


def port_policy(jparams, action_space, obs_shape, policy, input_scale=1):
    net = tpol.make_policy(action_space, obs_shape, policy, input_scale)
    kind = bridge.torso_kind_of(jparams)
    net.load_state_dict(bridge.flax_to_state_dict(jax.tree.map(np.asarray, jparams), kind))
    return net


@pytest.mark.parametrize("discrete", [True, False])
def test_mlp_actor_critic_matches(discrete):
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(8, 3)).astype(np.float32)
    jspace = jspaces.Discrete(6) if discrete else jspaces.Box(-1.0, 1.0, (3,))
    tspace = tspaces.Discrete(6) if discrete else tspaces.Box(-1.0, 1.0, (3,))
    jnet = jpol.make_policy(jspace, (3,), "mlp")
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    # Give the heads non-trivial biases and log_std.
    jparams = jax.tree.map(lambda x: x + 0.05 * jnp.cos(jnp.arange(x.size).reshape(x.shape)),
                           jparams)
    jd, jv = jnet.apply(jparams, jnp.asarray(obs))
    net = port_policy(jparams, tspace, (3,), "mlp")
    td, tv = net(torch.from_numpy(obs))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    if discrete:
        np.testing.assert_allclose(td.logits.detach().numpy(), np.asarray(jd.logits),
                                   rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(td.mean.detach().numpy(), np.asarray(jd.mean),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(td.log_std.detach().numpy(), np.asarray(jd.log_std),
                                   rtol=1e-6)


def test_bridge_roundtrip_is_exact():
    shape = (20, 20, 3)  # the smallest frame the coarse Nature CNN takes
    jnet = jpol.make_policy(jspaces.Discrete(6), shape, "cnn", input_scale=2)
    jparams = jax.tree.map(np.asarray, jnet.init(
        jax.random.PRNGKey(1), jnp.zeros((1,) + shape, jnp.uint8)))
    sd = bridge.flax_to_state_dict(jparams, "cnn")
    net = tpol.make_policy(tspaces.Discrete(6), shape, "cnn", input_scale=2)
    assert set(sd) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert sd[k].shape == v.shape, k
    back = bridge.state_dict_to_flax(sd, "cnn")
    jax.tree.map(np.testing.assert_array_equal, back, jparams)


# The main path's coarse 112x112 frames (conv1 folded), and a small
# full-resolution frame for the unfolded conv1.
@pytest.mark.parametrize("obs_hw,input_scale", [(112, 2), (84, 1)])
def test_nature_cnn_matches_in_bf16(obs_hw, input_scale):
    rng = np.random.default_rng(2)
    obs = rng.integers(0, 256, (4, obs_hw, obs_hw, 3), dtype=np.uint8)
    shape = (obs_hw, obs_hw, 3)
    jnet = jpol.make_policy(jspaces.Discrete(6), shape, "auto", input_scale=input_scale)
    jparams = jnet.init(jax.random.PRNGKey(3), jnp.asarray(obs))
    # Larger head weights, so that the logits carry the torso's rounding.
    jparams["params"]["pi"]["kernel"] = jparams["params"]["pi"]["kernel"] * 100.0
    jd, jv = jnet.apply(jparams, jnp.asarray(obs))
    net = port_policy(jparams, tspaces.Discrete(6), shape, "auto", input_scale)
    with torch.no_grad():
        td, tv = net(torch.from_numpy(obs))
    for out, ref in ((td.logits, jd.logits), (tv, jv)):
        ref = np.asarray(ref)
        err = np.abs(out.numpy() - ref).max()
        assert err <= 2e-2 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_conv1_fold_identity_and_reference_in_float32():
    """Image-scale inputs in [0, 1] and the layer's own orthogonal init, as
    in the policy."""
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(2, 20, 20, 3)).astype(np.float32)
    torch.manual_seed(4)
    conv = tpol._Conv1(3, input_scale=2)
    with torch.no_grad():
        conv.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 32).astype(np.float32)))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        folded = conv.conv(xt)
        up = xt.repeat_interleave(2, 2).repeat_interleave(2, 3)
        direct = F.conv2d(up, conv.weight, conv.bias, stride=4)
    np.testing.assert_allclose(folded.numpy(), direct.numpy(), atol=1e-5, rtol=0)
    # The reference layer on the same float32 input and weights.
    jconv = jpol._Conv1(input_scale=2)
    jparams = {"params": {"kernel": jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 1, 0)),
                          "bias": jnp.asarray(conv.bias.detach().numpy())}}
    ref = np.asarray(jconv.apply(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(folded.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=0)


def test_distributions_match():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(16, 6)).astype(np.float32)
    actions = rng.integers(0, 6, 16)
    jc, tc = jdist.Categorical(jnp.asarray(logits)), tdist.Categorical(torch.from_numpy(logits))
    np.testing.assert_allclose(tc.log_prob(torch.from_numpy(actions)).numpy(),
                               np.asarray(jc.log_prob(jnp.asarray(actions))), atol=1e-6)
    np.testing.assert_allclose(tc.entropy().numpy(), np.asarray(jc.entropy()), atol=1e-6)
    np.testing.assert_array_equal(tc.mode().numpy(), np.asarray(jc.mode()))

    mean = rng.normal(size=(16, 3)).astype(np.float32)
    log_std = np.broadcast_to(rng.normal(0, 0.3, 3).astype(np.float32), (16, 3))
    a = rng.normal(size=(16, 3)).astype(np.float32)
    jg = jdist.DiagGaussian(jnp.asarray(mean), jnp.asarray(log_std))
    tg = tdist.DiagGaussian(torch.from_numpy(mean), torch.from_numpy(log_std.copy()))
    np.testing.assert_allclose(tg.log_prob(torch.from_numpy(a)).numpy(),
                               np.asarray(jg.log_prob(jnp.asarray(a))), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tg.entropy().numpy(), np.asarray(jg.entropy()), atol=1e-6)


def test_categorical_sample_follows_probs():
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0]]).expand(20000, 4)
    gen = torch.Generator().manual_seed(0)
    counts = torch.bincount(tdist.Categorical(logits).sample(gen), minlength=4)
    freq = counts.numpy() / 20000
    np.testing.assert_allclose(freq, torch.softmax(logits[0], 0).numpy(), atol=0.015)
