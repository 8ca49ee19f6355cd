"""SRL encoder training (counterpart of srl_tpu/srl/trainer.py).

``SRLTrainer`` trains ``SRLModules`` on a recorded dataset (a dict with
observations, actions, rewards, episode_starts, ground_truth_states) with
the reference's loss families: autoencoder, dae, vae, supervised, forward,
inverse, reward, robotic priors and multi-view triplets, each on its slice
of the state vector when the model is split; ``fit_pca`` is the PCA
baseline. Semantics kept from the reference:

* forward, inverse, reward and priors encode (s, s_next) in one batch of 2B
  rows; a model with none of them does not encode the next frame; the
  triplet loss encodes its three views separately;
* the noise is an argument of ``_loss_fn`` (``draw_noise`` draws it): the
  dae adds N(0, 1) * 0.2 * 255 and clips to [0, 255], the vae
  reparameterizes its own slice only;
* ``fit()`` restarts from the same initial parameters (``params0``) on
  every call, shuffles the transition pairs with
  ``np.random.RandomState(seed).shuffle`` every epoch and drops the last
  partial minibatch, logs each epoch's LAST minibatch, and reports
  ``images_trained = epochs * n_batches * b_eff``;
* Adam is optax's ``adam(1e-3)`` (``core/optim.py``);
* an unknown loss name raises (the reference ignores it silently).

Checkpoints have the reference's layout: ``exp_config.json`` beside
``srl_model.pkl``, which holds ``{"exp_config", "params"}`` with the Flax
parameter tree as plain dicts of numpy arrays (``bridge``), so the
reference's ``loadSRLModel`` reads them.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from srl_tpu_torch import bridge
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.optim import adam_init, adam_update_
from srl_tpu_torch.srl.nets import RECON_LOSSES, SRLModules, split_ranges

LOSSES = ("triplet", "vae", "dae", "autoencoder", "supervised", "forward", "inverse",
          "reward", "priors")
PAIR_LOSSES = ("forward", "inverse", "reward", "priors")
ADAM_EPS = 1e-8


def _pairs_indices(episode_starts: np.ndarray) -> np.ndarray:
    """Indices i such that (i, i+1) is a transition within one episode."""
    ok = ~np.asarray(episode_starts[1:], bool)
    return np.nonzero(ok)[0].astype(np.int32)


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x), -1)


class SRLTrainer:
    def __init__(
        self,
        state_dim: int,
        losses: List[str],
        image_obs: bool = True,
        obs_shape: Tuple[int, ...] = (224, 224, 3),
        n_actions: int = 4,
        learning_rate: float = 1e-3,
        beta_vae: float = 1.0,
        noise_std_dae: float = 0.2,
        seed: int = 0,
        split_dimensions: Optional[Dict[str, int]] = None,
        device="cuda",
    ):
        unknown = [l for l in losses if l not in LOSSES]
        if unknown:
            raise ValueError(f"unknown SRL loss(es) {unknown}; known: {list(LOSSES)}")
        self.device = resolve_device(device)
        self.state_dim = state_dim
        self.losses = list(losses)
        self.split_dimensions = dict(split_dimensions) if split_dimensions else None
        self.ranges = split_ranges(self.losses, state_dim, self.split_dimensions)
        self.image_obs = image_obs
        self.obs_shape = tuple(obs_shape)
        self.n_actions = n_actions
        self.learning_rate = learning_rate
        self.beta_vae = beta_vae
        self.noise_std_dae = noise_std_dae
        self.seed = seed
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = SRLModules(state_dim, self.losses, self.obs_shape, image_obs,
                                    n_actions, self.split_dimensions)
        self.model.to(self.device)
        # The parameters every fit() starts from.
        self.params0 = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self._device_data = None

    # ------------------------------------------------------------------
    def draw_noise(self, gen: torch.Generator, batch_size: int) -> dict:
        """The random numbers one minibatch's loss takes: ``vae_eps`` [B, vae
        slice] for the vae, ``dae`` [B, *obs_shape] N(0, 1) for the dae."""
        if "triplet" in self.losses:
            return {}
        if "vae" in self.losses:
            a, b = self.ranges["vae"]
            return {"vae_eps": torch.randn((batch_size, b - a), generator=gen,
                                           device=gen.device)}
        if "dae" in self.losses:
            return {"dae": torch.randn((batch_size,) + self.obs_shape, generator=gen,
                                       device=gen.device)}
        return {}

    def _loss_fn(self, batch, noise: dict):
        """(total, logs) of one minibatch ``(obs, obs_next, actions,
        rewards, gt)`` with the model's current parameters."""
        obs, obs_next, actions, rewards, gt = batch
        m = self.model
        total = 0.0
        logs = {}

        if "triplet" in self.losses:
            c = obs.shape[-1] // 2
            anchor = m.encode(obs[..., :c])
            positive = m.encode(obs[..., c:])
            s = anchor
            s_next = m.encode(obs_next[..., :c])
            negative = torch.roll(positive, 1, 0)
            trip = torch.mean(torch.clamp(
                _sq_sum(anchor - positive) - _sq_sum(anchor - negative) + 1.0, min=0.0))
            total += trip
            logs["triplet"] = trip
        elif "vae" in self.losses:
            mu, log_var = m.vae_posterior(obs)
            a, b = self.ranges["vae"]
            mu_v = mu[..., a:b]
            s = torch.cat([mu[..., :a], mu_v + noise["vae_eps"] * torch.exp(0.5 * log_var),
                           mu[..., b:]], -1)
            s_next = m.encode(obs_next)
            kl = -0.5 * torch.mean(torch.sum(
                1 + log_var - torch.square(mu_v) - torch.exp(log_var), -1))
            total += self.beta_vae * kl * 0.001
            logs["kl"] = kl
        else:
            enc_in = obs
            if "dae" in self.losses:
                enc_in = torch.clamp(obs.to(torch.float32)
                                     + noise["dae"] * (self.noise_std_dae * 255.0), 0, 255)
            if any(l in self.losses for l in PAIR_LOSSES):
                # float32 is the encoder's first cast, so concatenating there
                # is exact for uint8 frames and keeps the dae noise.
                both = m.encode(torch.cat([enc_in.to(torch.float32),
                                           obs_next.to(torch.float32)], 0))
                s, s_next = torch.chunk(both, 2, 0)
            else:
                s = m.encode(enc_in)
                s_next = None  # no configured loss reads it

        if any(l in self.losses for l in RECON_LOSSES):
            recon = m.decode(s)
            target = obs.to(torch.float32) / 255.0 if self.image_obs else obs
            rec = torch.mean(torch.square(recon - target))
            total += rec
            logs["reconstruction"] = rec

        if "supervised" in self.losses:
            d = min(s.shape[-1], gt.shape[-1])
            sup = torch.mean(torch.square(s[..., :d] - gt[..., :d]))
            total += sup
            logs["supervised"] = sup

        if "forward" in self.losses:
            a_onehot = F.one_hot(actions.long(), self.n_actions).to(torch.float32)
            pred = m.predict_forward(s, a_onehot)
            fa, fb = self.ranges["forward"]
            fwd = torch.mean(torch.square(pred - s_next[..., fa:fb].detach()))
            total += fwd
            logs["forward"] = fwd

        if "inverse" in self.losses:
            inv = F.cross_entropy(m.predict_inverse(s, s_next), actions.long())
            total += 2.0 * inv
            logs["inverse"] = inv

        if "reward" in self.losses:
            classes = (torch.sign(rewards) + 1).long()
            rew = F.cross_entropy(m.predict_reward(s, s_next), classes)
            total += rew
            logs["reward"] = rew

        if "priors" in self.losses:
            # Robotic priors (Jonschkowski & Brock 2015): slowness,
            # variability, proportionality, repeatability.
            ds = s_next - s
            slowness = torch.mean(_sq_sum(ds))
            perm_s = torch.roll(s, 1, 0)
            similarity = torch.exp(-_sq_sum(s - perm_s))
            variability = torch.mean(similarity)
            ds_perm = torch.roll(ds, 1, 0)
            same_action = (actions == torch.roll(actions, 1, 0)).to(torch.float32)
            mag = torch.sqrt(_sq_sum(ds) + 1e-8)
            mag_p = torch.sqrt(_sq_sum(ds_perm) + 1e-8)
            n_same = torch.sum(same_action) + 1e-8
            proportionality = torch.sum(same_action * torch.square(mag - mag_p)) / n_same
            repeatability = torch.sum(same_action * similarity * _sq_sum(ds - ds_perm)) / n_same
            priors = slowness + variability + proportionality + repeatability
            total += priors
            logs["priors"] = priors

        logs["total"] = total
        return total, logs

    def train_step(self, batch, noise: dict, opt_state: dict) -> dict:
        """One Adam step on one minibatch; returns its detached logs."""
        params = dict(self.model.named_parameters())
        total, logs = self._loss_fn(batch, noise)
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        # A parameter the losses do not reach gets a zero gradient, as in JAX.
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        adam_update_(params, grads, opt_state, self.learning_rate, ADAM_EPS)
        return {k: v.detach() for k, v in logs.items()}

    # ------------------------------------------------------------------
    def _on_device(self, dataset) -> tuple:
        """The dataset's observations, action indices, rewards and ground
        truth on the device, copied once and cached on the identity of the
        four source arrays."""
        src = (dataset["observations"], dataset["actions"], dataset["rewards"],
               dataset["ground_truth_states"])
        cache = self._device_data
        if cache is not None and all(a is b for a, b in zip(cache[0], src)):
            return cache[1]
        actions = np.asarray(dataset["actions"])
        # Continuous actions: the inverse and priors losses see one bin.
        actions_idx = (np.zeros(len(actions), np.int64) if actions.ndim > 1
                       else actions.astype(np.int64))
        dev = lambda x: torch.as_tensor(np.asarray(x), device=self.device)
        tensors = (dev(dataset["observations"]), dev(actions_idx),
                   dev(np.asarray(dataset["rewards"], np.float32)),
                   dev(np.asarray(dataset["ground_truth_states"], np.float32)))
        self._device_data = (src, tensors)
        return tensors

    def fit(
        self,
        dataset: Dict[str, np.ndarray],
        epochs: int = 5,
        batch_size: int = 64,
        log_fn=None,
        updates_per_call: Optional[int] = None,
    ) -> Dict:
        """Train for ``epochs`` passes over the transition pairs, from
        ``params0``. ``updates_per_call`` minibatches share one upload of
        their index rows (default: the whole epoch); it changes only the
        scheduling. ``log_fn(epoch, logs)``, when given, sees each epoch's
        logs as it ends (a device sync per epoch)."""
        idx = _pairs_indices(np.asarray(dataset["episode_starts"], bool))
        rng = np.random.RandomState(self.seed)
        self.model.load_state_dict(self.params0)
        opt_state = adam_init(dict(self.model.named_parameters()))
        obs, actions, rewards, gt = self._on_device(dataset)

        b_eff = min(batch_size, len(idx))
        if b_eff < 2:
            raise ValueError("dataset has fewer than 2 transition pairs")
        n_batches = len(idx) // b_eff
        k = n_batches if updates_per_call is None else max(1, min(int(updates_per_call),
                                                                  n_batches))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        history_dev = []
        for epoch in range(epochs):
            rng.shuffle(idx)
            mat = idx[: n_batches * b_eff].reshape(n_batches, b_eff).astype(np.int64)
            logs = None
            for c in range(0, n_batches, k):
                rows = torch.from_numpy(mat[c:c + k]).to(self.device)
                for bidx in rows:
                    batch = (obs[bidx], obs[bidx + 1], actions[bidx], rewards[bidx],
                             gt[bidx])
                    logs = self.train_step(batch, self.draw_noise(gen, b_eff), opt_state)
            history_dev.append(logs)
            if log_fn is not None:
                log_fn(epoch, {name: float(v) for name, v in logs.items()})
        history = [{name: float(v) for name, v in logs.items()} for logs in history_dev]
        return {"history": history, "images_trained": epochs * n_batches * b_eff}

    # ------------------------------------------------------------------
    def encode(self, observations) -> np.ndarray:
        obs = torch.as_tensor(np.asarray(observations), device=self.device)
        if "triplet" in self.losses and obs.shape[-1] > self.obs_shape[2]:
            obs = obs[..., : self.obs_shape[2]]
        with torch.inference_mode():
            return self.model.encode(obs).cpu().numpy()

    def exp_config(self) -> dict:
        cfg = {
            "state-dim": self.state_dim,
            "losses": self.losses,
            "model-type": "custom_cnn" if self.image_obs else "mlp",
            "n_actions": self.n_actions,
            "obs-shape": list(self.obs_shape),
        }
        if self.split_dimensions:
            cfg["split-dimensions"] = {k: int(v) for k, v in self.split_dimensions.items()}
        return cfg

    def save(self, log_dir: str) -> str:
        """exp_config.json + srl_model.pkl; returns the model's path."""
        os.makedirs(log_dir, exist_ok=True)
        exp_config = self.exp_config()
        with open(os.path.join(log_dir, "exp_config.json"), "w") as f:
            json.dump(exp_config, f, indent=2)
        payload = {"exp_config": exp_config,
                   "params": bridge.srl_state_dict_to_flax(self.model.state_dict())}
        model_path = os.path.join(log_dir, "srl_model.pkl")
        with open(model_path, "wb") as f:
            pickle.dump(payload, f)
        return model_path


def fit_pca(observations: np.ndarray, state_dim: int, device="cuda") -> Dict:
    """PCA baseline over flattened pixels in [0, 1]: with fewer samples than
    features, the eigenvectors of the samples' Gram matrix, else an SVD.
    Each component's sign is arbitrary (as ``eigh``'s is)."""
    dev = resolve_device(device)
    x = np.asarray(observations, np.float32).reshape(len(observations), -1) / 255.0
    mean = x.mean(axis=0)
    xc = torch.as_tensor(x - mean, device=dev)
    if xc.shape[0] < xc.shape[1]:
        w, v = torch.linalg.eigh(xc @ xc.T)
        order = torch.argsort(w, descending=True)[:state_dim]
        w = torch.clamp(w[order], min=1e-8)
        components = (xc.T @ v[:, order]) / torch.sqrt(w)[None, :]
    else:
        components = torch.linalg.svd(xc, full_matrices=False)[2][:state_dim].T
    return {"mean": mean, "components": components.cpu().numpy().astype(np.float32),
            "state_dim": state_dim}


def save_pca(pca: Dict, log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "exp_config.json"), "w") as f:
        json.dump({"state-dim": pca["state_dim"], "losses": ["pca"],
                   "model-type": "pca"}, f)
    path = os.path.join(log_dir, "pca.pkl")
    with open(path, "wb") as f:
        pickle.dump(pca, f)
    return path
