"""srl_tpu_torch.srl.trainer against srl_tpu.srl.trainer on the CPU.

Every loss family of tests/test_srl.py:64-76, plus the triplet and the
split model srl_splits: the same initial parameters (carried over by the
bridge), the same minibatch of 32x32 frames, and the dae/vae noise that
JAX drew from the reference's key fed to the port.

Tolerances (the encoder's convs run in bfloat16 on both sides, rounded
differently by XLA and PyTorch, tests/test_torch_srl_nets.py):
* every logged loss term within 1e-3 of its magnitude (measured at most
  9e-5, the triplet);
* every parameter's gradient within 2e-2 of its norm (measured at most
  5e-3), but the biases of the bf16 convs and deconvs within 0.15 (their
  gradients are bf16 sums over every pixel; measured at most 0.093); a
  gradient norm under 1e-5 of the largest counts as 1e-5 of it, since a
  loss of state differences only (priors, triplet) gives the state layer's
  bias a zero gradient, which both sides compute as rounding noise;
* one Adam step: optax's update to 1e-6 relative (float32, same formula);
* ``fit`` (2 epochs of 5 minibatches, 8x8 frames): the same minibatches in
  the same order and the same ``images_trained`` exactly; each epoch's
  logged reconstruction within 1e-1 relative. Adam's first steps move a
  weight by about the learning rate whatever its gradient's size, so
  gradients near zero that round differently take different steps; and
  the reference's own fit is not repeatable on the CPU: two identical
  calls in one process differed by up to 4% by the second epoch (measured
  on this data; ROADMAP Queue C). The port's fit is: a second fit
  reproduces the first exactly (it restarts from ``params0``);
* PCA: each component equal up to its sign, to 1e-4 (float32 eigh).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srl_tpu.srl.trainer import SRLTrainer as JTrainer
from srl_tpu.srl.trainer import fit_pca as jfit_pca
from srl_tpu_torch import bridge
from srl_tpu_torch.core.optim import adam_init, adam_update_
from srl_tpu_torch.srl import trainer as ttrainer
from srl_tpu_torch.srl.registry import registered_srl

torch.set_num_threads(1)

B = 8
HW = (32, 32)
LOSS_TOL = 1e-3
FIT_TOL = 1e-1
GRAD_TOL = 2e-2
BF16_BIAS_GRAD_TOL = 0.15
BF16_BIASES = {"c1", "c2", "c3", "d1", "d2", "d3", "d4"}
SPLITS = registered_srl["srl_splits"]["splits"]

CASES = {
    "autoencoder": (["autoencoder"], None),
    "vae": (["vae"], None),
    "forward_inverse": (["forward", "inverse"], None),
    "reward": (["reward"], None),
    "priors": (["priors"], None),
    "supervised": (["supervised"], None),
    "combination": (["autoencoder", "inverse", "forward"], None),
    "dae": (["dae"], None),
    "triplet": (["triplet"], None),
    "srl_splits": (registered_srl["srl_splits"]["losses"], SPLITS),
}


def make_pair(losses, splits, obs_shape, state_dim=6, **kw):
    """A reference trainer with initial parameters, and the port's trainer
    holding the same parameters."""
    kw = dict(state_dim=state_dim, losses=list(losses), obs_shape=obs_shape, n_actions=4,
              split_dimensions=splits, **kw)
    jt = JTrainer(**kw)
    obs0 = jnp.zeros((2,) + obs_shape, jnp.uint8)
    batch0 = (obs0, obs0, jnp.zeros(2, jnp.int32), jnp.zeros(2), jnp.zeros((2, 2)))
    params = jax.tree.map(np.asarray, jax.jit(jt._init_full)(jax.random.PRNGKey(7), batch0))
    tt = ttrainer.SRLTrainer(device="cpu", **kw)
    tt.model.load_state_dict(bridge.srl_flax_to_state_dict(params))
    return jt, params, tt


def random_batch(obs_shape, seed=0):
    rng = np.random.RandomState(seed)
    obs = rng.randint(0, 256, (B,) + obs_shape).astype(np.uint8)
    obs_next = np.clip(obs.astype(np.int32) + rng.randint(-20, 21, obs.shape), 0, 255
                       ).astype(np.uint8)
    actions = rng.randint(0, 4, B).astype(np.int32)
    actions[1] = actions[0]  # two equal neighbours for the priors' same-action terms
    rewards = rng.choice([-1.0, 0.0, 1.0], B).astype(np.float32)
    gt = rng.randn(B, 2).astype(np.float32)
    return obs, obs_next, actions, rewards, gt


def jax_noise(jt, key, obs_shape) -> dict:
    """The normals the reference's ``_loss_fn`` draws from ``key``."""
    if "triplet" in jt.losses:
        return {}
    if "vae" in jt.losses:
        a, b = jt.ranges["vae"]
        return {"vae_eps": np.asarray(jax.random.normal(jax.random.split(key)[1],
                                                        (B, b - a)))}
    if "dae" in jt.losses:
        return {"dae": np.asarray(jax.random.normal(jax.random.split(key)[1],
                                                    (B,) + obs_shape))}
    return {}


def assert_loss_close(out, ref, name):
    assert abs(out - ref) <= LOSS_TOL * max(abs(ref), 1e-3), (name, out, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_terms_and_gradients_match(case):
    losses, splits = CASES[case]
    obs_shape = HW + (6 if case == "triplet" else 3,)
    jt, params, tt = make_pair(losses, splits, obs_shape, state_dim=8 if splits else 6)
    batch = random_batch(obs_shape)
    key = jax.random.PRNGKey(11)
    (jtotal, jlogs), jgrads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
        params, batch, key)

    noise = {k: torch.tensor(v) for k, v in jax_noise(jt, key, obs_shape).items()}
    tparams = dict(tt.model.named_parameters())
    total, logs = tt._loss_fn(tuple(torch.from_numpy(x) for x in batch), noise)
    grads = torch.autograd.grad(total, list(tparams.values()), allow_unused=True)
    assert set(logs) == set(jlogs)
    for name in jlogs:
        assert_loss_close(logs[name].item(), float(jlogs[name]), name)

    tgrads = bridge.srl_state_dict_to_flax({
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(tparams.items(), grads)})

    floor = 1e-5 * max(np.linalg.norm(g) for g in jax.tree.leaves(jgrads))

    def check(path, g_port, g_ref):
        g_ref = np.asarray(g_ref)
        layer, leaf = path[-2].key, path[-1].key
        tol = BF16_BIAS_GRAD_TOL if (layer, leaf) in {(c, "bias") for c in BF16_BIASES} \
            else GRAD_TOL
        err = np.linalg.norm(g_port - g_ref) / max(np.linalg.norm(g_ref), floor)
        assert err <= tol, (jax.tree_util.keystr(path), err)

    jax.tree_util.tree_map_with_path(check, tgrads, jgrads)


def test_one_adam_step_is_optax_adam():
    rng = np.random.RandomState(4)
    params = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = optax.adam(1e-3)
    jp, state = params, tx.init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = adam_init(tp)
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        adam_update_(tp, {k: torch.from_numpy(v) for k, v in g.items()}, opt, 1e-3,
                     ttrainer.ADAM_EPS)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def tiny_dataset(n=100):
    """The reference's chunking-test data: 8x8 frames, 5 episodes of 20;
    the ground truth's first column is the row index."""
    rng = np.random.RandomState(0)
    gt = rng.randn(n, 2).astype(np.float32)
    gt[:, 0] = np.arange(n)
    return {
        "observations": rng.randint(0, 255, (n, 8, 8, 3), np.uint8),
        "actions": rng.randint(0, 4, n).astype(np.int32),
        "rewards": rng.randn(n).astype(np.float32),
        "episode_starts": (np.arange(n) % 20 == 0),
        "ground_truth_states": gt,
    }


def test_fit_matches_reference_order_count_and_history():
    data = tiny_dataset()
    kw = dict(state_dim=2, losses=["autoencoder"], obs_shape=(8, 8, 3), n_actions=4)
    jt = JTrainer(**kw)
    jt.fit(data, epochs=0, batch_size=16)  # the reference's cached params0
    tt = ttrainer.SRLTrainer(device="cpu", **kw)
    tt.params0 = bridge.srl_flax_to_state_dict(jax.tree.map(np.asarray, jt._init_cache[2]))
    seen = []
    step = tt.train_step
    tt.train_step = lambda batch, noise, opt: seen.append(batch[4][:, 0].long()) or step(
        batch, noise, opt)

    ref = jt.fit(data, epochs=2, batch_size=16)
    out = tt.fit(data, epochs=2, batch_size=16)
    # 95 transition pairs, batch 16: 5 minibatches per epoch, 15 pairs dropped.
    assert out["images_trained"] == ref["images_trained"] == 2 * 5 * 16
    idx = ttrainer._pairs_indices(data["episode_starts"])
    rng = np.random.RandomState(0)
    expected = []
    for _ in range(2):
        rng.shuffle(idx)
        expected += list(idx[:80].reshape(5, 16).copy())
    assert len(seen) == 10
    for got, want in zip(seen, expected):
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(out["history"]) == len(ref["history"]) == 2
    for got, want in zip(out["history"], ref["history"]):
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= FIT_TOL * abs(want[k]), (k, got[k], want[k])

    # A second fit restarts from params0: the same history, bit for bit.
    after_first = {k: v.clone() for k, v in tt.model.state_dict().items()}
    again = tt.fit(data, epochs=2, batch_size=16)
    assert again["history"] == out["history"]
    assert all(torch.equal(v, tt.model.state_dict()[k]) for k, v in after_first.items())
    # updates_per_call changes only the scheduling.
    assert tt.fit(data, epochs=2, batch_size=16, updates_per_call=2)["history"] \
        == out["history"]


def test_fit_caches_the_device_copy_on_all_four_arrays():
    data = tiny_dataset()
    tt = ttrainer.SRLTrainer(state_dim=2, losses=["supervised"], obs_shape=(8, 8, 3),
                             device="cpu")
    tt.fit(data, epochs=1, batch_size=16)
    first = tt._device_data[1]
    tt.fit(data, epochs=1, batch_size=16)
    assert tt._device_data[1] is first
    changed = {**data, "ground_truth_states": data["ground_truth_states"] + 1.0}
    tt.fit(changed, epochs=1, batch_size=16)
    assert tt._device_data[1] is not first
    assert torch.equal(tt._device_data[1][3], torch.from_numpy(changed["ground_truth_states"]))


def test_random_model_init_only_and_too_few_pairs():
    data = tiny_dataset()
    tt = ttrainer.SRLTrainer(state_dim=2, losses=[], obs_shape=(8, 8, 3), device="cpu")
    out = tt.fit(data, epochs=0, batch_size=16)
    assert out == {"history": [], "images_trained": 0}
    assert all(torch.equal(v, tt.params0[k]) for k, v in tt.model.state_dict().items())
    one_pair = {**data, "episode_starts": np.arange(100) % 2 == 0}
    one_pair["episode_starts"][:] = True
    with pytest.raises(ValueError, match="fewer than 2"):
        tt.fit(one_pair, epochs=1)


@pytest.mark.parametrize("name", ["robotic_priors", "pca", "autoencoderx"])
def test_unknown_loss_names_raise(name):
    with pytest.raises(ValueError, match="unknown SRL loss"):
        ttrainer.SRLTrainer(state_dim=2, losses=["autoencoder", name], device="cpu")


@pytest.mark.parametrize("shape", [(40, 8, 8, 3), (60, 2, 2, 3)])
def test_pca_matches_up_to_sign(shape):
    """Fewer samples than features (Gram eigh), then more (SVD)."""
    obs = np.random.RandomState(5).randint(0, 256, shape).astype(np.uint8)
    ref = jfit_pca(obs, 4)
    out = ttrainer.fit_pca(obs, 4, device="cpu")
    np.testing.assert_array_equal(out["mean"], ref["mean"])
    assert out["components"].shape == ref["components"].shape == (int(np.prod(shape[1:])), 4)
    sign = np.sign(np.sum(out["components"] * ref["components"], 0))
    np.testing.assert_allclose(out["components"] * sign, ref["components"], atol=1e-4)
