"""Hyperparameter search: Hyperband and TPE (counterpart of
srl_tpu/experiments/hyperparam_search.py).

Both optimizers draw from one ``np.random.RandomState(seed)`` in the
reference's order, so the same seed and the same scores give the same
trials. An evaluation is a whole training run in this process
(``experiments/train.main`` on ``--device``) scored by the mean reward of
its last 10 episodes, NaN or a failed run scoring -inf. The trials go to a
CSV, one row each: the score, then the parameters in sorted order.

    python -m srl_tpu_torch.experiments.hyperparam_search --algo ppo2 \
        --env MobileRobotGymEnv-v0 --srl-model ground_truth \
        --optimizer hyperband --max-eval 3 --num-timesteps 20000 [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import math
import tempfile
from typing import Dict, List

import numpy as np

from srl_tpu_torch.agents.registry import registered_rl
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.utils.logging import printGreen, printYellow
from srl_tpu_torch.utils.monitor import compute_mean_reward


def sample_param(rng, spec):
    kind, bounds = spec
    if kind is int:
        lo, hi = sorted(bounds)
        return int(rng.randint(lo, hi + 1))
    if kind is float:
        lo, hi = sorted(bounds)
        return float(rng.uniform(lo, hi))
    # categorical: ((list, str), choices)
    return rng.choice(bounds)


def train_and_score(algo, env, srl_model, params: Dict, num_timesteps: int,
                    base_log_dir: str, seed: int = 0, device: str = "cuda") -> float:
    """One evaluation: a training run on ``device``, scored by the mean reward of
    its last 10 episodes (-inf for NaN or a failed run)."""
    from srl_tpu_torch.experiments.train import main as train_main

    argv = ["--algo", algo, "--env", env, "--srl-model", srl_model,
            "--num-timesteps", str(num_timesteps), "--seed", str(seed),
            "--log-dir", base_log_dir, "--no-vis", "--device", str(device)]
    if params:
        argv += ["--hyperparam"] + [f"{k}:{v}" for k, v in params.items()]
    try:
        log_dir = train_main(argv)
    except Exception as e:
        printYellow(f"Trial failed: {e}")
        return -float("inf")
    ok, mean_reward = compute_mean_reward(log_dir, 10)
    if not ok or math.isnan(mean_reward):
        return -float("inf")
    return mean_reward


class Hyperband:
    """Successive halving: brackets of configs, each round keeping the
    best 1/eta of them at eta times the budget."""

    def __init__(self, param_space, eval_fn, max_iter=81, eta=3, seed=0):
        self.param_space = param_space
        self.eval_fn = eval_fn  # (params, budget) -> score
        self.max_iter = max_iter
        self.eta = eta
        self.s_max = int(math.log(max_iter) / math.log(eta))
        self.B = (self.s_max + 1) * max_iter
        self.rng = np.random.RandomState(seed)
        self.history: List[tuple] = []

    def sample(self) -> Dict:
        return {k: sample_param(self.rng, spec)
                for k, spec in self.param_space.items()}

    def run(self):
        best = (-float("inf"), None)
        for s in reversed(range(self.s_max + 1)):
            n = int(math.ceil(self.B / self.max_iter / (s + 1) * self.eta**s))
            r = self.max_iter * self.eta ** (-s)
            configs = [self.sample() for _ in range(n)]
            for i in range(s + 1):
                n_i = int(n * self.eta ** (-i))
                r_i = int(r * self.eta**i)
                scores = [self.eval_fn(c, r_i) for c in configs[:n_i]]
                for c, sc in zip(configs[:n_i], scores):
                    self.history.append((sc, r_i, c))
                    if sc > best[0]:
                        best = (sc, c)
                order = np.argsort(scores)[::-1]
                configs = [configs[j] for j in order[: max(n_i // self.eta, 1)]]
        return best


class TPE:
    """Two-density tree-structured Parzen estimator over numeric params."""

    def __init__(self, param_space, eval_fn, max_evals=20, gamma=0.25,
                 n_candidates=24, seed=0):
        self.param_space = param_space
        self.eval_fn = eval_fn
        self.max_evals = max_evals
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = np.random.RandomState(seed)
        self.history: List[tuple] = []

    def _kde_logpdf(self, x, samples, lo, hi):
        if len(samples) == 0:
            return 0.0
        bw = max((hi - lo) / 5.0, 1e-12)
        d = (x - np.asarray(samples)) / bw
        return float(np.log(np.mean(np.exp(-0.5 * d * d)) + 1e-12))

    def suggest(self) -> Dict:
        if len(self.history) < 5:
            return {k: sample_param(self.rng, spec)
                    for k, spec in self.param_space.items()}
        scores = np.array([h[0] for h in self.history])
        cut = np.quantile(scores, 1 - self.gamma)
        good = [h[1] for h in self.history if h[0] >= cut]
        bad = [h[1] for h in self.history if h[0] < cut]
        best_cand, best_ei = None, -float("inf")
        for _ in range(self.n_candidates):
            cand = {}
            ei = 0.0
            for k, spec in self.param_space.items():
                kind, bounds = spec
                if kind in (int, float):
                    lo, hi = sorted(bounds)
                    gs = [g[k] for g in good]
                    # Sample around a good point.
                    center = self.rng.choice(gs) if gs else self.rng.uniform(lo, hi)
                    x = np.clip(
                        center + self.rng.randn() * (hi - lo) / 5.0, lo, hi
                    )
                    if kind is int:
                        x = int(round(x))
                    cand[k] = kind(x)
                    ei += self._kde_logpdf(x, gs, lo, hi) - self._kde_logpdf(
                        x, [b[k] for b in bad], lo, hi
                    )
                else:
                    cand[k] = self.rng.choice(bounds)
            if ei > best_ei:
                best_ei, best_cand = ei, cand
        return best_cand

    def run(self, budget_per_eval: int):
        best = (-float("inf"), None)
        for _ in range(self.max_evals):
            params = self.suggest()
            score = self.eval_fn(params, budget_per_eval)
            self.history.append((score, params))
            if score > best[0]:
                best = (score, params)
        return best


def main(argv=None):
    parser = argparse.ArgumentParser(description="Hyperparameter search")
    parser.add_argument("--algo", type=str, default="ppo2", choices=list(registered_rl.keys()))
    parser.add_argument("--env", type=str, default="MobileRobotGymEnv-v0")
    parser.add_argument("--srl-model", type=str, default="ground_truth")
    parser.add_argument("--optimizer", type=str, default="hyperband",
                        choices=["hyperband", "tpe"])
    parser.add_argument("--max-eval", type=int, default=20)
    parser.add_argument("--num-timesteps", type=int, default=int(1e5),
                        help="Budget unit (steps per hyperband resource unit / per TPE eval)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-dir", type=str, default=None)
    parser.add_argument("--output", type=str, default="hyperparam_results.csv")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    param_space = registered_rl[args.algo][0].getOptParam()
    assert param_space is not None, (
        f"Error: {args.algo} does not expose opt params (getOptParam)")
    base_log_dir = args.log_dir or tempfile.mkdtemp(prefix="hyperparam_")

    def eval_fn(params, budget_units):
        return train_and_score(args.algo, args.env, args.srl_model, params,
                               num_timesteps=args.num_timesteps * max(int(budget_units), 1),
                               base_log_dir=base_log_dir, seed=args.seed, device=device.type)

    if args.optimizer == "hyperband":
        opt = Hyperband(param_space, eval_fn, max_iter=max(args.max_eval, 3), seed=args.seed)
        best_score, best_params = opt.run()
        history = [(s, c) for s, _, c in opt.history]
    else:
        opt = TPE(param_space, eval_fn, max_evals=args.max_eval, seed=args.seed)
        best_score, best_params = opt.run(budget_per_eval=1)
        history = opt.history

    with open(args.output, "w", newline="") as f:
        keys = sorted(param_space.keys())
        writer = csv.writer(f)
        writer.writerow(["score"] + keys)
        for score, params in history:
            writer.writerow([score] + [params.get(k) for k in keys])
    printGreen(f"Best score {best_score:.3f} with params {best_params}")
    printGreen(f"History saved to {args.output}")
    return best_score, best_params


if __name__ == "__main__":
    main()
