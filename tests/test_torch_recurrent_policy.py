"""srl_tpu_torch.models.recurrent against srl_tpu.models.recurrent on the
CPU, the reference's parameters carried over by srl_tpu_torch.bridge.

``LstmActorCritic`` for every recurrent policy kind, one step and an 8-step
segment of 4 envs from a random carry with dones in the middle (a done must
zero the carry before its step): the reference steps its module 8 times,
the port runs the segment in one call (the torso once over the 32 frames).

Tolerances: ``lstm``/``lnlstm`` (MLP torso, float32) within rtol 1e-5 (atol
1e-6): the cell's matmuls and the LayerNorm's means sum in another order;
``cnnlstm``/``cnnlnlstm`` (the bf16 Nature CNN at 36x36 and 44x44) within
2e-2 of each output's scale (max |reference|), as tests/test_torch_policy.py
holds the Nature CNN. The bridge round trip is exact.

The ``gpu`` case runs the cnnlstm policy on the card against the CPU at the
same tolerance (bf16 convolutions from two libraries).
"""
import numpy as np
import pytest
import torch

from srl_tpu_torch import bridge
from srl_tpu_torch.core import spaces as tspaces
from srl_tpu_torch.models.recurrent import make_recurrent_policy, mask_carry

torch.set_num_threads(1)

B, T, H = 4, 8, 64
CASES = [("lstm", (3,)), ("lnlstm", (3,)), ("cnnlstm", (36, 36, 3)),
         ("cnnlnlstm", (44, 44, 3))]


@pytest.fixture(scope="module")
def jax_ref():
    """(jax, the reference's recurrent module, its spaces), imported here so
    that the ``gpu`` test also runs where JAX is not installed."""
    jax = pytest.importorskip("jax")
    from srl_tpu.core import spaces as jspaces
    from srl_tpu.models import recurrent as jrec

    return jax, jrec, jspaces


def inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    if len(shape) == 3:
        obs = rng.integers(0, 256, (T, B) + shape, dtype=np.uint8)
    else:
        obs = rng.normal(size=(T, B) + shape).astype(np.float32)
    done = np.zeros((T, B), bool)
    done[3, 1] = done[5, 2] = done[5, 0] = True
    c0, h0 = (rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    return obs, done, c0, h0


def reference_and_port(jax_ref, policy, shape, discrete=True):
    """(the reference module's jitted ``apply``, its parameters, the port's
    module with them)."""
    jax, jrec, jspaces = jax_ref
    space = jspaces.Discrete(4) if discrete else jspaces.Box(-1, 1, (2,))
    tspace = tspaces.Discrete(4) if discrete else tspaces.Box(-1, 1, (2,))
    jnet = jrec.make_recurrent_policy(space, policy)
    obs, done, c0, h0 = inputs(shape)
    jparams = jax.tree.map(np.asarray, jnet.init(
        jax.random.PRNGKey(1), obs[0], (c0, h0), done[0]))
    net = make_recurrent_policy(tspace, shape, policy)
    net.load_state_dict(bridge.recurrent_flax_to_state_dict(jparams))
    return jax.jit(jnet.apply), jparams, net


def close(out, ref, cnn):
    out, ref = out.detach().numpy(), np.asarray(ref)
    if cnn:
        assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("policy,shape", CASES, ids=[c[0] for c in CASES])
def test_segment_with_dones_matches_reference(jax_ref, policy, shape):
    japply, jparams, net = reference_and_port(jax_ref, policy, shape)
    obs, done, c0, h0 = inputs(shape)
    carry, logits, values = (c0, h0), [], []
    for t in range(T):
        dist, value, carry = japply(jparams, obs[t], carry, done[t])
        logits.append(np.asarray(dist.logits))
        values.append(np.asarray(value))
    with torch.no_grad():
        tdist, tvalue, tcarry = net(torch.from_numpy(obs), (torch.from_numpy(c0),
                                                            torch.from_numpy(h0)),
                                    torch.from_numpy(done))
    cnn = policy.startswith("cnn")
    close(tdist.logits, np.stack(logits), cnn)
    close(tvalue, np.stack(values), cnn)
    for got, ref in zip(tcarry, carry):  # the carry is (c, h), as Flax's
        close(got, ref, cnn)


@pytest.mark.parametrize("policy,shape", CASES, ids=[c[0] for c in CASES])
def test_one_step_matches_reference(jax_ref, policy, shape):
    japply, jparams, net = reference_and_port(jax_ref, policy, shape)
    obs, done, c0, h0 = inputs(shape, seed=3)
    jdist, jvalue, jcarry = japply(jparams, obs[5], (c0, h0), done[5])
    with torch.no_grad():
        dist, value, carry = net(torch.from_numpy(obs[5]),
                                 (torch.from_numpy(c0), torch.from_numpy(h0)),
                                 torch.from_numpy(done[5]))
    cnn = policy.startswith("cnn")
    close(dist.logits, jdist.logits, cnn)
    close(value, jvalue, cnn)
    for got, ref in zip(carry, jcarry):
        close(got, ref, cnn)


def test_done_zeroes_the_carry_and_gaussian_heads_match(jax_ref):
    japply, jparams, net = reference_and_port(jax_ref, "lnlstm", (3,), discrete=False)
    obs, done, c0, h0 = inputs((3,))
    all_done = np.ones(B, bool)
    jdist, jvalue, _ = japply(jparams, obs[0], (c0, h0), all_done)
    with torch.no_grad():
        zero = net.initial_state(B)
        fresh, fresh_value, _ = net(torch.from_numpy(obs[0]), zero, torch.zeros(B, dtype=bool))
        dist, value, _ = net(torch.from_numpy(obs[0]),
                             (torch.from_numpy(c0), torch.from_numpy(h0)),
                             torch.from_numpy(all_done))
    assert torch.equal(dist.mean, fresh.mean) and torch.equal(value, fresh_value)
    close(dist.mean, jdist.mean, False)
    close(value, jvalue, False)
    masked = mask_carry((torch.from_numpy(c0), torch.from_numpy(h0)), torch.from_numpy(done[5]))
    assert not masked[0][0].any() and not masked[1][2].any() and masked[0][3].any()


@pytest.mark.parametrize("policy,shape", [("lnlstm", (3,)), ("cnnlnlstm", (36, 36, 3))])
def test_bridge_roundtrip_is_exact(jax_ref, policy, shape):
    _, jparams, net = reference_and_port(jax_ref, policy, shape)
    sd = bridge.recurrent_flax_to_state_dict(jparams)
    assert set(sd) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert sd[k].shape == v.shape, k
    jax = jax_ref[0]
    jax.tree.map(np.testing.assert_array_equal, bridge.recurrent_state_dict_to_flax(sd),
                 jparams)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cnnlstm_on_card_matches_cpu(cuda_device):
    shape = (112, 112, 3)
    torch.manual_seed(0)
    net = make_recurrent_policy(tspaces.Discrete(6), shape, "cnnlstm")
    obs, done, c0, h0 = inputs(shape)
    args = (torch.from_numpy(obs), (torch.from_numpy(c0), torch.from_numpy(h0)),
            torch.from_numpy(done))
    with torch.no_grad():
        dist, value, carry = net(*args)
        on_card = net.to(cuda_device)(*(
            x.to(cuda_device) if torch.is_tensor(x) else tuple(y.to(cuda_device) for y in x)
            for x in args))
    for got, ref in zip((on_card[0].logits, on_card[1], *on_card[2]),
                        (dist.logits, value, *carry)):
        close(got.cpu(), ref.numpy(), True)
