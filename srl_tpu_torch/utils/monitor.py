"""Episode-monitor CSV (counterpart of srl_tpu/utils/monitor.py): the
stable-baselines ``bench.Monitor`` format, ``<rank>.monitor.csv`` with a JSON
header line and ``r,l,t`` rows, so the reference's plotting and replay tools
read port runs."""
from __future__ import annotations

import csv
import glob
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np


class MonitorWriter:
    EXT = "monitor.csv"

    def __init__(self, path: str, env_id: str = "", rank: int = 0,
                 append: bool = False):
        """``append``: continue an existing file (a resumed run) without a
        second header; a missing file is started as usual."""
        os.makedirs(path, exist_ok=True)
        self.t_start = time.time()
        self.file_path = os.path.join(path, f"{rank}.{self.EXT}")
        resuming = append and os.path.exists(self.file_path)
        self._f = open(self.file_path, "a" if resuming else "w", newline="")
        self._writer = csv.DictWriter(self._f, fieldnames=("r", "l", "t"))
        if not resuming:
            self._f.write("#%s\n" % json.dumps({"t_start": self.t_start,
                                                 "env_id": env_id}))
            self._writer.writeheader()
        self._f.flush()

    def write_episode(self, reward: float, length: int, t: Optional[float] = None):
        if t is None:
            t = time.time() - self.t_start
        self._writer.writerow(
            {"r": round(float(reward), 6), "l": int(length), "t": round(t, 6)}
        )
        self._f.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def load_csv(file_path: str) -> Dict[str, np.ndarray]:
    """One monitor CSV -> ``{"r", "l", "t"}`` arrays and its ``header``."""
    with open(file_path) as f:
        first = f.readline()
        header = json.loads(first[1:]) if first.startswith("#") else {}
        rows = list(csv.DictReader(f))
    return {
        "r": np.array([float(row["r"]) for row in rows], np.float64),
        "l": np.array([int(row["l"]) for row in rows], np.int64),
        "t": np.array([float(row["t"]) for row in rows], np.float64),
        "header": header,
    }


def load_results(log_dir: str) -> List[Dict[str, np.ndarray]]:
    """Every monitor file of a log dir, sorted by rank."""
    files = sorted(glob.glob(os.path.join(log_dir, f"*.{MonitorWriter.EXT}")))
    return [load_csv(f) for f in files]


def compute_mean_reward(log_dir: str, last_n_episodes: int) -> tuple:
    """(ok, mean reward over the last ``last_n_episodes`` episodes of every
    monitor file); (False, 0.0) when there is no episode."""
    results = load_results(log_dir)
    if not results:
        return False, 0.0
    rewards = np.concatenate([r["r"] for r in results])
    if len(rewards) == 0:
        return False, 0.0
    return True, float(np.mean(rewards[-last_n_episodes:]))
