"""CMA-ES over the parameters of a small policy (counterpart of
srl_tpu/agents/cma_es.py).

The reference's defaults: a population of 20 (one env each), sigma 0.14,
the mean starting at ``mu`` = 0, 260 steps a generation; the policy an MLP
``in -> 100 relu -> out`` (``_MLPPolicy``) or, on images, ``_CNNPolicy``:
``x / 255`` in float32, three Flax convs (8 x 5x5, 16 x 3x3, 32 x 3x3,
stride 2, SAME padding, which is asymmetric on strided convs: conv1 on 224
pads 1 before and 2 after), each followed by relu and a VALID 2x2
max-pool, then a Dense over the NHWC-flattened features.

Each population member is one flat vector in the reference's
``ravel_pytree`` layout (``bridge.cmaes_layout``), so a reference
``cma-es`` pickle acts the same here. The whole population runs in
lock-step, each env with its own member's parameters on its own frame:
the convolutions are one grouped convolution (``groups=P``, the members'
kernels stacked over a ``[1, P C, H, W]`` input), the Dense layers a
batched matmul; the rollout is ARS's (``population_returns``).

The CMA update is Hansen's standard algorithm (rank-one plus rank-mu
covariance update, the sigma path, ``h_sig``, an eigendecomposition every
generation), in float64 on the agent's device (``torch.linalg.eigh``, the
inverse square root and the rank-mu term as matrix products): at 224x224
pixels n is 7,572 and C alone 459 MB. Two things stay on the host with
numpy, as in the reference: the draws ``z = RandomState(seed).randn(P,
n)`` and the ranking ``np.argsort(-r)`` over the float32 returns, whose
ties then resolve as the reference's. ``ask`` and ``tell`` split the
update, so a test can feed the reference's eigendecomposition (LAPACK and
the port's ``eigh`` may choose opposite signs for an eigenvector).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from srl_tpu_torch import bridge
from srl_tpu_torch.agents.base import BaseRLAgent, as_tensor_on
from srl_tpu_torch.agents.common import population_actions, population_returns
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.core.spaces import Discrete
from srl_tpu_torch.utils.logging import softmax

CONVS = ((5, 8), (3, 16), (3, 32))  # (kernel, channels) of _CNNPolicy's convs


@dataclasses.dataclass
class CMAESConfig:
    num_population: int = 20
    mu: float = 0.0
    sigma: float = 0.14
    deterministic: bool = False
    max_episode_steps: int = 260


def _pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Flax's SAME padding of a stride-``s`` conv: the total split with the
    smaller half before."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def policy_logits(leaves: Dict[str, torch.Tensor], obs: torch.Tensor) -> torch.Tensor:
    """Logits [B, G, out] of G parameter sets (``leaves``: ``{"module/leaf":
    [G, *shape]}``, ``bridge.cmaes_unravel``) on observations [B, G, ...]:
    set g acts on column g. The population is B = 1, G = P; one set over a
    batch is G = 1."""
    b, g = obs.shape[:2]
    if "Conv_0/kernel" not in leaves:
        x = obs.reshape(b, g, -1).to(torch.float32)
        h = torch.relu(torch.einsum("bgi,gih->bgh", x, leaves["Dense_0/kernel"])
                       + leaves["Dense_0/bias"])
        return torch.einsum("bgh,gho->bgo", h, leaves["Dense_1/kernel"]) + leaves["Dense_1/bias"]
    h_in, w_in, c = obs.shape[2:]
    x = (obs.to(torch.float32) / 255.0).permute(0, 1, 4, 2, 3).reshape(b, g * c, h_in, w_in)
    for i, (k, n_out) in enumerate(CONVS):
        kernel = leaves[f"Conv_{i}/kernel"]  # [G, k, k, C_in, C_out] (HWIO)
        weight = kernel.permute(0, 4, 3, 1, 2).reshape(g * n_out, kernel.shape[3], k, k)
        x = F.conv2d(_pad_same(x, k, 2), weight, leaves[f"Conv_{i}/bias"].reshape(-1),
                     stride=2, groups=g)
        x = F.max_pool2d(torch.relu(x), 2, 2)
    h, w = x.shape[-2:]
    x = x.reshape(b, g, CONVS[-1][1], h, w).permute(0, 1, 3, 4, 2).reshape(b, g, -1)
    return torch.einsum("bgf,gfo->bgo", x, leaves["Dense_0/kernel"]) + leaves["Dense_0/bias"]


@dataclasses.dataclass
class CMAState:
    """The CMA-ES search state, float64 on the device; ``B`` and ``D`` the
    eigendecomposition the next ``ask`` samples with."""

    mean: torch.Tensor  # [n]
    sigma: float
    C: torch.Tensor  # [n, n]
    ps: torch.Tensor  # [n]
    pc: torch.Tensor  # [n]
    B: torch.Tensor  # [n, n]
    D: torch.Tensor  # [n]
    generation: int = 0
    best_return: float = -math.inf


def cma_constants(P: int, n: int) -> dict:
    """Hansen's constants for a population of P in n dimensions, as the
    reference computes them (numpy float64)."""
    mu_sel = P // 2
    weights = np.log(mu_sel + 0.5) - np.log(np.arange(1, mu_sel + 1))
    weights /= weights.sum()
    mueff = 1.0 / np.sum(weights**2)
    cs = (mueff + 2) / (n + mueff + 5)
    c1 = 2 / ((n + 1.3) ** 2 + mueff)
    return dict(
        mu_sel=mu_sel, weights=weights, mueff=mueff, cs=cs, c1=c1,
        cc=(4 + mueff / n) / (n + 4 + 2 * mueff / n),
        cmu=min(1 - c1, 2 * (mueff - 2 + 1 / mueff) / ((n + 2) ** 2 + mueff)),
        damps=1 + 2 * max(0, np.sqrt((mueff - 1) / (n + 1)) - 1) + cs,
        chi_n=np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n**2)),
    )


class CMAES(BaseRLAgent):
    name = "cma-es"
    config_class = CMAESConfig

    def __init__(self, env=None, config: CMAESConfig = None, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.env = env
        self.config = config or CMAESConfig()
        if env is not None:
            self.num_envs = self.config.num_population
            self.vec_env = VecEnv(env, self.num_envs)
            self.discrete = isinstance(env.action_space, Discrete)
            out_dim = (env.action_space.n if self.discrete
                       else int(np.prod(env.action_space.shape)))
            self.layout = bridge.cmaes_layout(tuple(env.observation_space.shape), out_dim)
            self.dim = sum(int(np.prod(shape)) for _, _, shape in self.layout)
            self.best_model = np.full(self.dim, self.config.mu, np.float32)

    def logits(self, flat: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """Logits [B, G, out] of the flat float32 vectors [G, n] on
        observations [B, G, ...] (``policy_logits``)."""
        return policy_logits(bridge.cmaes_unravel(flat, self.layout), obs)

    # ---- a generation -------------------------------------------------------------
    def eval_population(self, pop: torch.Tensor, gen: torch.Generator, gumbel=None,
                        reset_noise=None) -> torch.Tensor:
        """Returns [P] of the float32 population [P, n], member i acting in
        env i; ``gumbel`` [T, P, A] and the first reset's noise, when given,
        replace the draws from ``gen``."""
        return population_returns(self.vec_env, self.population_policy(pop, gen, gumbel), gen,
                                  self.config.max_episode_steps, reset_noise)

    def population_policy(self, pop: torch.Tensor, gen: torch.Generator, gumbel=None):
        """``act(obs, t)`` of the float32 population [P, n] in lock-step."""
        cfg = self.config

        def act(obs, t):
            logits = self.logits(pop, obs[None])[0]
            return population_actions(logits, self.discrete, cfg.deterministic, gen,
                                      None if gumbel is None else gumbel[t])

        return act

    def initial_cma(self, mean: np.ndarray) -> CMAState:
        n, f64 = self.dim, dict(dtype=torch.float64, device=self.device)
        eye = torch.eye(n, **f64)
        return CMAState(mean=torch.as_tensor(np.asarray(mean, np.float64), **f64),
                        sigma=float(self.config.sigma), C=eye, ps=torch.zeros(n, **f64),
                        pc=torch.zeros(n, **f64), B=eye.clone(), D=torch.ones(n, **f64))

    @staticmethod
    def eigen(C: torch.Tensor, eigh=torch.linalg.eigh):
        """(B, D) of C: its eigenvectors and the square roots of its
        eigenvalues floored at 1e-20 (``eigh(C)`` -> (eigenvalues,
        eigenvectors); a test gives the reference's)."""
        d2, B = eigh(C)
        return B, torch.sqrt(torch.clamp_min(d2, 1e-20))

    @staticmethod
    def ask(s: CMAState, z: torch.Tensor):
        """The steps ``y = z diag(D) B^T`` and the population ``mean + sigma
        y`` (float64 [P, n]) of the draws ``z`` [P, n]."""
        y = (z * s.D) @ s.B.T
        return y, s.mean[None] + s.sigma * y

    def tell(self, s: CMAState, y: torch.Tensor, pop: torch.Tensor, r: np.ndarray,
             k: dict) -> CMAState:
        """The state after the generation whose steps ``y``, population
        ``pop`` and float32 returns ``r`` [P] are given (``k``:
        ``cma_constants``); the best member so far in ``self.best_model``.
        ``B`` and ``D`` stay those of the generation: the caller refreshes
        them (``eigen``)."""
        order = np.argsort(-r)  # on the host, as the reference ranks
        if r[order[0]] > s.best_return:
            s.best_return = r[order[0]]
            self.best_model = pop[int(order[0])].to(torch.float32).cpu().numpy()
        n, g = self.dim, s.generation
        weights = torch.as_tensor(k["weights"], device=self.device)
        artmp = y[torch.as_tensor(order[:k["mu_sel"]], device=self.device)]
        y_w = weights @ artmp
        mean = s.mean + s.sigma * y_w
        cs, cc, c1, cmu, mueff = k["cs"], k["cc"], k["c1"], k["cmu"], k["mueff"]
        c_inv_sqrt = (s.B * (1.0 / s.D)) @ s.B.T
        ps = (1 - cs) * s.ps + np.sqrt(cs * (2 - cs) * mueff) * (c_inv_sqrt @ y_w)
        ps_norm = float(torch.linalg.vector_norm(ps))
        h_sig = (ps_norm / np.sqrt(1 - (1 - cs) ** (2 * (g + 1)))
                 < (1.4 + 2 / (n + 1)) * k["chi_n"])
        pc = (1 - cc) * s.pc + h_sig * np.sqrt(cc * (2 - cc) * mueff) * y_w
        C = ((1 - c1 - cmu) * s.C
             + c1 * (torch.outer(pc, pc) + (not h_sig) * cc * (2 - cc) * s.C)
             + ((cmu * artmp.T) * weights) @ artmp)
        sigma = s.sigma * np.exp((cs / k["damps"]) * (ps_norm / k["chi_n"] - 1))
        return CMAState(mean=mean, sigma=float(sigma), C=C, ps=ps, pc=pc, B=s.B, D=s.D,
                        generation=g + 1, best_return=s.best_return)

    def learn(self, total_timesteps: int, seed: int = 0, callback: Optional[Callable] = None):
        """``max(1, total_timesteps // (max_episode_steps P))`` generations
        from the mean ``mu`` (or a loaded policy's ``best_model``, with
        ``self.pretrained``), ``callback(locals, globals)`` after each with
        the generation's mean return, the best so far, sigma and the seconds
        of its ``eigh``. Returns ``best_model``."""
        cfg, P = self.config, self.config.num_population
        k = cma_constants(P, self.dim)
        start = (self.pretrained if self.pretrained is not None
                 else np.full(self.dim, cfg.mu, np.float64))
        s = self.initial_cma(start)
        gen = self._start(seed)
        rng = np.random.RandomState(seed)
        steps_per_gen = cfg.max_episode_steps * P
        n_generations = max(1, int(total_timesteps) // steps_per_gen)
        t_start = time.time()
        episode_returns = []
        for g in range(n_generations):
            t_eigh = time.perf_counter()
            s.B, s.D = self.eigen(s.C)
            s.D.sum().item()  # the eigendecomposition done, for its time
            t_eigh = time.perf_counter() - t_eigh
            z = torch.as_tensor(rng.randn(P, self.dim), device=self.device)
            y, pop = self.ask(s, z)
            r = self.eval_population(pop.to(torch.float32), gen).cpu().numpy()
            episode_returns.append(float(r.mean()))
            s = self.tell(s, y, pop, r, k)
            if callback is not None:
                callback({"self": self, "update": g, "n_updates": n_generations,
                          "num_timesteps": (g + 1) * steps_per_gen,
                          "episode_returns": episode_returns, "episode_lengths": [],
                          "metrics": {"mean_return": float(r.mean()),
                                      "best_return": float(s.best_return),
                                      "sigma": s.sigma, "eigh_s": t_eigh},
                          "state": None,
                          "fps": (g + 1) * steps_per_gen / max(time.time() - t_start, 1e-9)},
                         {})
        self.state = self.best_model
        return self.best_model

    # ---- the reference's surface -----------------------------------------------------
    def customArguments(self, parser):
        super().customArguments(parser)
        parser.add_argument("--num-population", type=int, default=20)
        parser.add_argument("--mu", type=float, default=0.0)
        parser.add_argument("--sigma", type=float, default=0.14)
        parser.add_argument("--deterministic", action="store_true", default=False)
        return parser

    @classmethod
    def getOptParam(cls):
        return {"sigma": (float, (0, 0.2))}

    def _best_logits(self, observation) -> torch.Tensor:
        obs = as_tensor_on(observation, self.device)
        flat = torch.as_tensor(np.asarray(self.best_model, np.float32), device=self.device)
        return self.logits(flat[None], obs[:, None])[:, 0]

    @torch.no_grad()
    def getAction(self, observation, dones=None, deterministic: bool = True, *,
                  gen: Optional[torch.Generator] = None):
        """``best_model``'s argmax, or its logits clipped to [-1, 1]
        (``deterministic`` and ``gen`` are there for the common call forms;
        the reference's CMA-ES always acts so)."""
        logits = self._best_logits(observation)
        if self.discrete:
            return torch.argmax(logits, -1).cpu().numpy()
        return torch.clamp(logits, -1, 1).cpu().numpy()

    @torch.no_grad()
    def getActionProba(self, observation, dones=None):
        logits = self._best_logits(observation).cpu().numpy()
        return softmax(logits) if self.discrete else logits

    def save(self, save_path: str, _locals=None):
        self._save_pickle(save_path, {"name": self.name,
                                      "config": dataclasses.asdict(self.config),
                                      "best_model": np.asarray(self.best_model, np.float32)})

    @classmethod
    def load(cls, load_path: str, env=None, args=None, *, device="cuda"):
        """The agent of a ``cma-es`` pickle (either package's)."""
        d = cls._load_pickle(load_path)
        agent = cls(env=env, config=CMAESConfig(**d["config"]), device=device)
        agent.best_model = np.asarray(d["best_model"], np.float32)
        agent.state = agent.best_model
        return agent

    def state_to_reference(self, s):
        """``self.state`` as the reference's: ``best_model``, or None before
        ``learn`` ends (the reference sets it then)."""
        return None if s is None else np.asarray(s, np.float32)
