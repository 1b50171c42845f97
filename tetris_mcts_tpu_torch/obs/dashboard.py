"""The live dashboard (counterpart of the reference package's
`obs/dashboard.py`): a stdlib HTTP server whose one page polls a JSON
endpoint, `/data`, fed by a run's metrics JSONL (`obs/metrics.
MetricsReader`), its live-state memmaps (`obs/metrics.StatusReader`) and
the weight histograms of a checkpoint it watches.

`/data` holds the episodes (n, lines, score), the training sessions
(losses, rows, grad norm), the throughput windows' sims/s, game 0's board
and the histograms. `weight_histograms` reads the port's checkpoint
(`torch.save`) or the JAX package's (`train/flax_msgpack.py`, numpy only):
one histogram a weight matrix or kernel (the reference's `kernel` leaves;
norm scales and biases are left out), named by its layer.

    python -m tetris_mcts_tpu_torch dashboard --metrics runs/m.jsonl \
        --status_dir ./tmp --checkpoint ckpt.pt --port 8050
"""

from __future__ import annotations

import json
import os
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tetris_mcts_tpu_torch.obs.metrics import MetricsReader, StatusReader

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tetris-tpu dashboard</title>
<style>
.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f1f0ec;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e3e2dd;
  --series-1: #2a78d6; --series-2: #eb6834; --series-3: #1baf7a;
  --cell-locked: #2a78d6; --cell-piece: #eb6834;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #242422;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #33332f;
    --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
    --cell-locked: #3987e5; --cell-piece: #d95926;
  }
}
body { margin: 0; font: 13px/1.45 system-ui, sans-serif; }
.viz-root { background: var(--surface-1); color: var(--text-primary);
            min-height: 100vh; padding: 16px 20px; }
h1 { font-size: 16px; margin: 0 0 12px; }
.tiles { display: flex; gap: 12px; flex-wrap: wrap; margin-bottom: 16px; }
.tile { background: var(--surface-2); border-radius: 8px; padding: 10px 16px;
        min-width: 110px; }
.tile .v { font-size: 22px; font-weight: 600; }
.tile .k { color: var(--text-secondary); font-size: 11px; }
.grid2 { display: grid; grid-template-columns: repeat(auto-fit, minmax(340px, 1fr));
         gap: 16px; }
.card { background: var(--surface-2); border-radius: 8px; padding: 12px; }
.card h2 { font-size: 12px; font-weight: 600; margin: 0 0 6px;
           color: var(--text-secondary); }
svg text { fill: var(--text-secondary); font-size: 10px; }
svg .axis { stroke: var(--grid); stroke-width: 1; }
.legend { display: flex; gap: 14px; font-size: 11px;
          color: var(--text-secondary); margin: 2px 0 4px; }
.legend .sw { display: inline-block; width: 10px; height: 10px;
              border-radius: 2px; margin-right: 4px; vertical-align: -1px; }
#tip { position: fixed; pointer-events: none; background: var(--surface-1);
       border: 1px solid var(--grid); border-radius: 6px; padding: 4px 8px;
       font-size: 11px; display: none; z-index: 10; }
</style></head>
<body><div class="viz-root">
<h1>tetris_mcts_tpu — live self-play</h1>
<div class="tiles" id="tiles"></div>
<div class="grid2">
  <div class="card"><h2>Lines cleared per episode</h2><svg id="c_lines" width="100%" height="180"></svg></div>
  <div class="card"><h2>Score per episode</h2><svg id="c_score" width="100%" height="180"></svg></div>
  <div class="card"><h2>Mean lines per 50 episodes</h2><svg id="c_lines50" width="100%" height="180"></svg></div>
  <div class="card"><h2>Training loss</h2>
    <div class="legend"><span><span class="sw" style="background:var(--series-1)"></span>train</span>
    <span><span class="sw" style="background:var(--series-2)"></span>validation</span></div>
    <svg id="c_loss" width="100%" height="180"></svg></div>
  <div class="card"><h2>Gradient norm per session</h2><svg id="c_gnorm" width="100%" height="180"></svg></div>
  <div class="card"><h2>Training data size per session</h2><svg id="c_rows" width="100%" height="180"></svg></div>
  <div class="card"><h2>Search throughput (sims/s per window)</h2><svg id="c_tp" width="100%" height="180"></svg></div>
  <div class="card"><h2>Live board (game 0)</h2><svg id="c_board" width="200" height="400"></svg></div>
  <div class="card" id="card_w" style="display:none"><h2>Weight histograms (checkpoint)</h2>
    <div id="c_weights" style="display:grid;grid-template-columns:repeat(auto-fit,minmax(150px,1fr));gap:8px"></div></div>
</div>
<div id="tip"></div>
<script>
const tip = document.getElementById('tip');
function lineChart(svg, seriesList, colors) {
  const W = svg.clientWidth || 360, H = +svg.getAttribute('height');
  const P = {l: 38, r: 8, t: 8, b: 18};
  svg.setAttribute('viewBox', `0 0 ${W} ${H}`);
  svg.innerHTML = '';
  const all = seriesList.flat();
  if (!all.length) return;
  const xs = seriesList.map(s => s.map((_, i) => i));
  // reduce, not spread: Math.max(...arr) throws past ~125k arguments,
  // exactly on the long runs the dashboard exists to monitor
  const nmax = seriesList.reduce((a, s) => Math.max(a, s.length), 0) - 1 || 1;
  const ymax = all.reduce((a, v) => Math.max(a, v), 1e-9);
  const ymin = all.reduce((a, v) => Math.min(a, v), 0);
  const X = i => P.l + (W - P.l - P.r) * i / nmax;
  const Y = v => H - P.b - (H - P.t - P.b) * (v - ymin) / (ymax - ymin || 1);
  const ns = 'http://www.w3.org/2000/svg';
  for (const f of [ymin, (ymin + ymax) / 2, ymax]) {
    const g = document.createElementNS(ns, 'line');
    g.setAttribute('x1', P.l); g.setAttribute('x2', W - P.r);
    g.setAttribute('y1', Y(f)); g.setAttribute('y2', Y(f));
    g.setAttribute('class', 'axis'); svg.appendChild(g);
    const t = document.createElementNS(ns, 'text');
    t.setAttribute('x', 2); t.setAttribute('y', Y(f) + 3);
    t.textContent = (+f.toPrecision(3)).toLocaleString(); svg.appendChild(t);
  }
  seriesList.forEach((s, k) => {
    if (!s.length) return;
    const pl = document.createElementNS(ns, 'polyline');
    pl.setAttribute('points', s.map((v, i) => `${X(i)},${Y(v)}`).join(' '));
    pl.setAttribute('fill', 'none'); pl.setAttribute('stroke', colors[k]);
    pl.setAttribute('stroke-width', '2'); svg.appendChild(pl);
  });
  svg.onmousemove = e => {
    const r = svg.getBoundingClientRect();
    const i = Math.round((e.clientX - r.left - P.l) / (W - P.l - P.r) * nmax);
    if (i < 0 || i > nmax) { tip.style.display = 'none'; return; }
    const vals = seriesList.map(s => s[i]).filter(v => v !== undefined);
    if (!vals.length) return;
    tip.style.display = 'block';
    tip.style.left = (e.clientX + 12) + 'px'; tip.style.top = (e.clientY + 12) + 'px';
    tip.textContent = `#${i}: ` + vals.map(v => (+v.toPrecision(4)).toLocaleString()).join(' / ');
  };
  svg.onmouseleave = () => tip.style.display = 'none';
}
function board(svg, cells) {
  const ns = 'http://www.w3.org/2000/svg';
  svg.innerHTML = '';
  if (!cells) return;
  const cw = 19, ch = 19;
  svg.setAttribute('viewBox', '0 0 200 400');
  for (let r = 0; r < 20; r++) for (let c = 0; c < 10; c++) {
    const v = cells[r][c];
    if (!v) continue;
    const rect = document.createElementNS(ns, 'rect');
    rect.setAttribute('x', c * 20 + 1); rect.setAttribute('y', r * 20 + 1);
    rect.setAttribute('width', cw - 1); rect.setAttribute('height', ch - 1);
    rect.setAttribute('rx', 3);
    rect.setAttribute('fill', v === 1 ? 'var(--cell-locked)' : 'var(--cell-piece)');
    svg.appendChild(rect);
  }
}
function tile(k, v) {
  return `<div class="tile"><div class="v">${v}</div><div class="k">${k}</div></div>`;
}
function histChart(svg, counts, lo, hi, color) {
  const W = 150, H = 60;
  svg.setAttribute('viewBox', `0 0 ${W} ${H}`);
  svg.innerHTML = '';
  const ns = 'http://www.w3.org/2000/svg';
  const cmax = counts.reduce((a, v) => Math.max(a, v), 1);
  const bw = (W - 2) / counts.length;
  counts.forEach((c, i) => {
    if (!c) return;
    const r = document.createElementNS(ns, 'rect');
    const h = Math.max(1, (H - 14) * c / cmax);
    r.setAttribute('x', 1 + i * bw); r.setAttribute('y', H - 12 - h);
    r.setAttribute('width', Math.max(bw - 0.5, 0.5)); r.setAttribute('height', h);
    r.setAttribute('fill', color); svg.appendChild(r);
  });
  for (const [x, v, anchor] of [[1, lo, 'start'], [W - 1, hi, 'end']]) {
    const t = document.createElementNS(ns, 'text');
    t.setAttribute('x', x); t.setAttribute('y', H - 2);
    t.setAttribute('text-anchor', anchor);
    t.textContent = (+v.toPrecision(2)).toLocaleString(); svg.appendChild(t);
  }
}
function weightPanels(box, weights, color) {
  document.getElementById('card_w').style.display = weights.length ? '' : 'none';
  box.innerHTML = '';
  for (const w of weights) {
    const d = document.createElement('div');
    d.innerHTML = `<div style="font-size:10px;color:var(--text-secondary)">${w.name}</div>` +
                  `<svg width="100%" height="60"></svg>`;
    box.appendChild(d);
    histChart(d.querySelector('svg'), w.counts, w.lo, w.hi, color);
  }
}
function per50(eps) {
  const out = [];
  for (let i = 0; i + 50 <= eps.length; i += 50)
    out.push(eps.slice(i, i + 50).reduce((a, e) => a + e.lines, 0) / 50);
  return out;
}
const css = s => getComputedStyle(document.querySelector('.viz-root')).getPropertyValue(s).trim();
async function tick() {
  try {
    const d = await (await fetch('data')).json();
    const eps = d.episodes;
    document.getElementById('tiles').innerHTML =
      tile('episodes', eps.length.toLocaleString()) +
      tile('best lines', eps.length ? eps.reduce((a, e) => Math.max(a, e.lines), 0).toLocaleString() : '—') +
      tile('mean lines (last 50)', eps.length ? (eps.slice(-50).reduce((a, e) => a + e.lines, 0) / Math.min(eps.length, 50)).toFixed(1) : '—') +
      tile('best score', eps.length ? eps.reduce((a, e) => Math.max(a, e.score), 0).toLocaleString() : '—') +
      tile('training sessions', d.trains.length.toLocaleString()) +
      tile('sims/s (last window)', d.tp && d.tp.length ? (+d.tp[d.tp.length - 1].toPrecision(4)).toLocaleString() : '—');
    const c1 = css('--series-1'), c2 = css('--series-2'), c3 = css('--series-3');
    lineChart(document.getElementById('c_lines'), [eps.map(e => e.lines)], [c1]);
    lineChart(document.getElementById('c_score'), [eps.map(e => e.score)], [c1]);
    lineChart(document.getElementById('c_lines50'), [per50(eps)], [c3]);
    lineChart(document.getElementById('c_loss'),
              [d.trains.map(t => t.loss_train), d.trains.map(t => t.loss_val)],
              [c1, c2]);
    // keep x aligned with the loss/rows charts: sessions without a grad
    // norm (non-VV trainers) plot as 0 rather than compacting the series
    lineChart(document.getElementById('c_gnorm'),
              [d.trains.map(t => t.grad_norm ?? 0)], [c2]);
    lineChart(document.getElementById('c_rows'),
              [d.trains.map(t => t.rows || 0)], [c3]);
    lineChart(document.getElementById('c_tp'), [d.tp || []], [c2]);
    board(document.getElementById('c_board'), d.board);
    weightPanels(document.getElementById('c_weights'), d.weights || [], c1);
  } catch (e) { /* server restarting */ }
  setTimeout(tick, 2000);
}
tick();
</script>
</div></body></html>
"""


def _kernels(path: str) -> dict:
    """layer name -> weight array of every kernel in a checkpoint: the
    port's (its net's params of 2 or more dims: `net`, or a DQN
    checkpoint's `dqn_net`) or the JAX package's (its `kernel` leaves)."""
    if zipfile.is_zipfile(path):
        import torch

        blob = torch.load(path, map_location="cpu", weights_only=True)
        sd = blob.get("net", blob.get("dqn_net", {}))
        return {name.rsplit(".", 1)[0]: v.numpy() for name, v in sd.items()
                if name.endswith(".weight") and v.dim() >= 2}
    from tetris_mcts_tpu_torch.train import flax_msgpack

    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == "kernel":
                out["/".join(p for p in path if p != "params") or "kernel"] = np.asarray(v)

    walk(flax_msgpack.read_jax_checkpoint(path)["params"], ())
    return out


def weight_histograms(checkpoint_path: str, bins: int = 32) -> list:
    """A histogram (`bins` bins over [min, max]) of every kernel of the
    checkpoint, by layer name."""
    out = []
    for name, w in sorted(_kernels(checkpoint_path).items()):
        w = np.asarray(w, np.float32).ravel()
        lo, hi = float(w.min()), float(w.max())
        counts, _ = np.histogram(w, bins=bins, range=(lo, hi or 1.0))
        out.append({"name": name, "counts": counts.tolist(), "lo": lo, "hi": hi})
    return out


class DashboardState:
    """What `/data` serves, read again at every request."""

    def __init__(self, metrics_path: str, status_dir: str = "", batch: int = 1,
                 checkpoint: str = ""):
        self.reader = MetricsReader(metrics_path)
        self.status = StatusReader(status_dir, batch=batch) if status_dir else None
        self.checkpoint = checkpoint
        self._ckpt_mtime = -1.0
        self._weights: list = []
        self._lock = threading.Lock()

    def _poll_checkpoint(self) -> list:
        """The histograms, made again when the checkpoint's mtime moves."""
        if not self.checkpoint or not os.path.isfile(self.checkpoint):
            return self._weights
        mtime = os.path.getmtime(self.checkpoint)
        if mtime > self._ckpt_mtime:
            try:
                self._weights = weight_histograms(self.checkpoint)
                self._ckpt_mtime = mtime
            except Exception:  # noqa: BLE001 — a checkpoint mid-write; the next poll retries
                pass
        return self._weights

    def snapshot(self) -> dict:
        with self._lock:
            self.reader.poll()
            episodes = [{"n": e.get("n"), "lines": e.get("lines", 0), "score": e.get("score", 0)}
                        for e in self.reader.of_kind("episode")]
            trains = [{"n": e.get("n"), "loss_train": e.get("loss_train"),
                       "loss_val": e.get("loss_val"), "rows": e.get("rows"),
                       "grad_norm": e.get("grad_norm")}
                      for e in self.reader.of_kind("train_session")
                      if e.get("loss_train") is not None]
            tp = [e.get("sims_per_s", 0.0) for e in self.reader.of_kind("throughput")]
            weights = self._poll_checkpoint()
        board = None
        if self.status is not None:
            st = self.status.read()
            if st is not None:
                board = st["board"].tolist()
        return {"episodes": episodes, "trains": trains, "board": board, "weights": weights,
                "tp": tp}


def make_handler(state: DashboardState):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") in ("", "/index.html"):
                body, ctype = _PAGE.encode(), "text/html; charset=utf-8"
            elif self.path.lstrip("/") == "data":
                body, ctype = json.dumps(state.snapshot()).encode(), "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    return Handler


def serve(metrics_path: str, status_dir: str = "", batch: int = 1, port: int = 8050,
          blocking: bool = True, checkpoint: str = "", host: str = "0.0.0.0"):
    """Start the dashboard server on `host`:`port` (0: a free port, read it
    from the returned server's `server_address`). Blocking, it serves until
    interrupted; else it serves from a daemon thread and returns the server
    (`shutdown()` stops it)."""
    state = DashboardState(metrics_path, status_dir, batch, checkpoint)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    if blocking:
        print(f"dashboard: http://localhost:{httpd.server_address[1]}", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        httpd.server_close()
        return httpd
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
