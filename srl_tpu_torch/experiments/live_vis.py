"""Live learning curves of a run over HTTP (counterpart of
srl_tpu/experiments/live_vis.py): a threaded stdlib server that reads the
run's monitor CSV and ``metrics.jsonl`` on each request and serves the
reference's self-refreshing page (reward against timesteps and against
episodes, and the windowed mean reward) and its ``data.json``, with the same
keys, so one browser tab reads a run of either package.

``experiments/train.py`` starts one unless ``--no-vis`` (a busy port skips).
On a finished or running log dir:

    python -m srl_tpu_torch.experiments.live_vis --log-dir LOG_DIR [--port 8097]
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>srl_tpu live training</title>
<style>
 body { font-family: sans-serif; margin: 1.5em; background: #fafafa; }
 h2 { margin: 0.2em 0; font-size: 1.1em; }
 .meta { color: #555; margin-bottom: 1em; }
 .chart { background: #fff; border: 1px solid #ddd; margin-bottom: 1.2em; }
 text { font-size: 11px; fill: #333; }
 .axis { stroke: #999; stroke-width: 1; }
 .grid { stroke: #eee; stroke-width: 1; }
 .raw { stroke: #9ecae1; stroke-width: 1; fill: none; }
 .smooth { stroke: #1f77b4; stroke-width: 2; fill: none; }
</style></head>
<body>
<h1 style="font-size:1.3em">srl_tpu live training <span id="title"></span></h1>
<div class="meta" id="meta">waiting for data…</div>
<div id="charts"></div>
<script>
function polyline(xs, ys, w, h, pad, cls, xmin, xmax, ymin, ymax) {
  if (xs.length < 2) return "";
  const sx = x => pad + (x - xmin) / Math.max(xmax - xmin, 1e-9) * (w - 2*pad);
  const sy = y => h - pad - (y - ymin) / Math.max(ymax - ymin, 1e-9) * (h - 2*pad);
  let pts = xs.map((x, i) => sx(x).toFixed(1) + "," + sy(ys[i]).toFixed(1));
  return `<polyline class="${cls}" points="${pts.join(" ")}"/>`;
}
function chart(title, xs, ysRaw, ysSmooth, xlabel) {
  const w = 640, h = 280, pad = 42;
  const all = ysRaw.concat(ysSmooth);
  if (!xs.length || !all.length) return "";
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  let ymin = Math.min(...all), ymax = Math.max(...all);
  if (ymin === ymax) { ymin -= 1; ymax += 1; }
  let g = `<svg class="chart" width="${w}" height="${h}">`;
  g += `<text x="${w/2}" y="16" text-anchor="middle" font-weight="bold">${title}</text>`;
  for (let i = 0; i <= 4; i++) {
    const y = pad + i * (h - 2*pad) / 4;
    const v = (ymax - i * (ymax - ymin) / 4);
    g += `<line class="grid" x1="${pad}" y1="${y}" x2="${w-pad}" y2="${y}"/>`;
    g += `<text x="${pad-4}" y="${y+4}" text-anchor="end">${v.toPrecision(3)}</text>`;
  }
  g += `<line class="axis" x1="${pad}" y1="${h-pad}" x2="${w-pad}" y2="${h-pad}"/>`;
  g += `<line class="axis" x1="${pad}" y1="${pad}" x2="${pad}" y2="${h-pad}"/>`;
  g += `<text x="${w/2}" y="${h-6}" text-anchor="middle">${xlabel}</text>`;
  g += polyline(xs, ysRaw, w, h, pad, "raw", xmin, xmax, ymin, ymax);
  if (ysSmooth.length) g += polyline(xs, ysSmooth, w, h, pad, "smooth", xmin, xmax, ymin, ymax);
  return g + "</svg>";
}
function movAvg(ys, n) {
  let out = [], s = 0;
  for (let i = 0; i < ys.length; i++) {
    s += ys[i]; if (i >= n) s -= ys[i-n];
    out.push(s / Math.min(i+1, n));
  }
  return out;
}
async function refresh() {
  try {
    const r = await fetch("data.json"); const d = await r.json();
    document.getElementById("title").textContent = "— " + (d.title || "");
    document.getElementById("meta").textContent =
      `${d.episodes.length} episodes · ${d.num_timesteps} timesteps · ` +
      `mean reward (last ${d.window}): ${d.mean_reward} · ${d.fps} steps/s`;
    const ts = d.episode_timesteps, ret = d.episodes;
    let htm = chart("Reward vs timesteps", ts, ret, movAvg(ret, d.window), "timesteps");
    htm += chart("Reward vs episodes", ret.map((_, i) => i + 1), ret,
                 movAvg(ret, d.window), "episodes");
    const mx = d.metrics_timesteps, my = d.metrics_mean_reward;
    htm += chart(`Mean reward (window ${d.window}) vs timesteps`, mx, my, [], "timesteps");
    document.getElementById("charts").innerHTML = htm;
  } catch (e) { /* run may not have data yet */ }
  setTimeout(refresh, 2000);
}
refresh();
</script></body></html>
"""


def read_run_data(log_dir: str, window: int = 40) -> dict:
    """What the page plots: the episodes of the run's monitor CSVs (rewards
    and cumulative timesteps) and the ``metrics.jsonl`` lines."""
    episodes, ep_lengths = [], []
    for name in sorted(os.listdir(log_dir)):
        if not name.endswith("monitor.csv"):
            continue
        with open(os.path.join(log_dir, name)) as f:
            if not f.readline().startswith("#"):  # the JSON header line
                f.seek(0)
            for row in csv.DictReader(f):
                try:
                    episodes.append(float(row["r"]))
                    ep_lengths.append(int(float(row["l"])))
                except (KeyError, ValueError):
                    pass
    ts, acc = [], 0
    for length in ep_lengths:
        acc += length
        ts.append(acc)
    if len(ts) < len(episodes):
        ts += list(range(len(ts), len(episodes)))

    metrics_ts, metrics_mean, num_timesteps, fps = [], [], 0, 0.0
    mpath = os.path.join(log_dir, "metrics.jsonl")
    if os.path.exists(mpath):
        with open(mpath) as f:
            for line in f:
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:  # a line being written
                    continue
                num_timesteps = e.get("num_timesteps", num_timesteps)
                fps = e.get("fps") or fps
                if e.get("mean_reward") is not None:
                    metrics_ts.append(e["num_timesteps"])
                    metrics_mean.append(e["mean_reward"])

    mean_reward = (round(sum(episodes[-window:]) / max(len(episodes[-window:]), 1), 2)
                   if episodes else None)
    return {
        "title": os.path.basename(os.path.normpath(log_dir)),
        "window": window,
        "episodes": episodes,
        "episode_timesteps": ts,
        "metrics_timesteps": metrics_ts,
        "metrics_mean_reward": metrics_mean,
        "num_timesteps": num_timesteps,
        "mean_reward": mean_reward,
        "fps": round(fps, 1),
    }


class LiveVisServer:
    """One run's live curves on ``port`` (0 takes a free one), served from a
    daemon thread. ``start`` returns False when the port is busy (another
    run serves there), so that training goes on without it."""

    def __init__(self, log_dir: str, port: int = 8097, window: int = 40):
        self.log_dir = log_dir
        self.port = port
        self.window = window
        self._httpd = None
        self._thread = None

    def start(self) -> bool:
        log_dir, window = self.log_dir, self.window

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server's name)
                if self.path in ("/", "/index.html"):
                    body, ctype = _PAGE.encode(), "text/html; charset=utf-8"
                elif self.path.startswith("/data.json"):
                    body = json.dumps(read_run_data(log_dir, window)).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # no line per request
                pass

        try:
            self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        except OSError:
            return False
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return True

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve live learning curves for a training log dir")
    parser.add_argument("--log-dir", type=str, required=True)
    parser.add_argument("--port", type=int, default=8097)
    parser.add_argument("--episode-window", type=int, default=40)
    args = parser.parse_args(argv)
    server = LiveVisServer(args.log_dir, args.port, args.episode_window)
    if not server.start():
        raise SystemExit(f"port {args.port} already in use")
    print(f"Serving live curves for {args.log_dir} at http://localhost:{server.port}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
