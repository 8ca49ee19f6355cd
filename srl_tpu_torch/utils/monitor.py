"""Episode-monitor CSV (counterpart of srl_tpu/utils/monitor.py): the
stable-baselines ``bench.Monitor`` format, ``<rank>.monitor.csv`` with a JSON
header line and ``r,l,t`` rows, so the reference's plotting and replay tools
read port runs."""
from __future__ import annotations

import csv
import json
import os
import time
from typing import Optional


class MonitorWriter:
    EXT = "monitor.csv"

    def __init__(self, path: str, env_id: str = "", rank: int = 0):
        os.makedirs(path, exist_ok=True)
        self.t_start = time.time()
        self.file_path = os.path.join(path, f"{rank}.{self.EXT}")
        self._f = open(self.file_path, "w", newline="")
        self._writer = csv.DictWriter(self._f, fieldnames=("r", "l", "t"))
        self._f.write("#%s\n" % json.dumps({"t_start": self.t_start, "env_id": env_id}))
        self._writer.writeheader()
        self._f.flush()

    def write_episode(self, reward: float, length: int, t: Optional[float] = None):
        if t is None:
            t = time.time() - self.t_start
        self._writer.writerow(
            {"r": round(float(reward), 6), "l": int(length), "t": round(t, 6)}
        )
        self._f.flush()

    def close(self):
        self._f.close()
