"""Scrubable HTML visualization of a solver run (counterpart of
ilqgames_tpu/viz_html.py) — the capability the reference GUI provided
interactively, as a self-contained artifact.

Capability parity with the reference's interactive stack
(gui/control_sliders.h:53-110, gui/top_down_renderer.h:57-107,
gui/cost_inspector.h:62-100): an ITERATE slider and a TIME slider drive
a top-down canvas of every player's planned trajectory + current pose
(triangle oriented by heading when the model has one), with per-player
total costs and per-iterate cost curves alongside. Redesigned as a
dependency-free HTML file (embedded JSON + vanilla JS) instead of an
OpenGL event loop: it works headless, archives with experiment logs, and
needs no display server. It reads numpy from the port's SolverLog and
needs nothing but numpy and json.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ilqgames_tpu_torch.utils.solver_log import SolverLog
from ilqgames_tpu_torch.viz import _agent_xy_theta

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: sans-serif; margin: 16px; background: #fafafa; }}
 #wrap {{ display: flex; gap: 24px; }}
 canvas {{ border: 1px solid #ccc; background: white; }}
 .panel {{ min-width: 280px; }}
 .sl {{ width: 100%; }}
 table {{ border-collapse: collapse; font-size: 13px; }}
 td, th {{ border: 1px solid #ddd; padding: 2px 8px; text-align: right; }}
</style></head><body>
<h3>{title}</h3>
<div id="wrap">
 <div>
  <canvas id="cv" width="640" height="640"></canvas><br>
  <label>iterate <input class="sl" id="it" type="range" min="0"
    max="{max_it}" value="{max_it}"></label>
  <span id="itv"></span><br>
  <label>time <input class="sl" id="tk" type="range" min="0"
    max="{max_k}" value="0"></label> <span id="tkv"></span>
 </div>
 <div class="panel">
  <h4>total costs (iterate)</h4>
  <table id="costs"></table>
  <h4>cost vs iterate</h4>
  <canvas id="cc" width="280" height="160"></canvas>
  <p id="conv"></p>
  <div id="inspwrap" style="display:none">
   <h4>cost inspector (stage cost vs time)</h4>
   <select id="pl"></select> <select id="cn"></select><br>
   <canvas id="ci" width="280" height="160"></canvas>
  </div>
 </div>
</div>
<script>
const D = {data};
const cv = document.getElementById('cv'), cx = cv.getContext('2d');
const cc = document.getElementById('cc'), ccx = cc.getContext('2d');
const itS = document.getElementById('it'), tkS = document.getElementById('tk');
const colors = ['#d62728','#1f77b4','#2ca02c','#9467bd','#ff7f0e','#8c564b'];
function world2px(x, y) {{
  const s = cv.width / (D.hi - D.lo);
  return [(x - D.lo) * s, cv.height - (y - D.lo) * s];
}}
function draw() {{
  const it = +itS.value, k = +tkS.value;
  document.getElementById('itv').textContent = it;
  document.getElementById('tkv').textContent =
    (k * D.dt).toFixed(1) + ' s';
  cx.clearRect(0, 0, cv.width, cv.height);
  cx.strokeStyle = '#bbb';
  for (const lane of D.lanes) {{
    cx.beginPath();
    lane.forEach((p, i) => {{
      const q = world2px(p[0], p[1]);
      i ? cx.lineTo(q[0], q[1]) : cx.moveTo(q[0], q[1]);
    }});
    cx.stroke();
  }}
  D.tracks[it].forEach((tr, p) => {{
    cx.strokeStyle = colors[p % colors.length];
    cx.lineWidth = 2;
    cx.beginPath();
    tr.x.forEach((x, i) => {{
      const q = world2px(x, tr.y[i]);
      i ? cx.lineTo(q[0], q[1]) : cx.moveTo(q[0], q[1]);
    }});
    cx.stroke();
    const q = world2px(tr.x[k], tr.y[k]);
    cx.fillStyle = colors[p % colors.length];
    if (tr.th) {{
      const a = tr.th[k], r = 9;
      cx.beginPath();
      cx.moveTo(q[0] + r * Math.cos(a), q[1] - r * Math.sin(a));
      cx.lineTo(q[0] + r * 0.6 * Math.cos(a + 2.5),
                q[1] - r * 0.6 * Math.sin(a + 2.5));
      cx.lineTo(q[0] + r * 0.6 * Math.cos(a - 2.5),
                q[1] - r * 0.6 * Math.sin(a - 2.5));
      cx.closePath(); cx.fill();
    }} else {{
      cx.beginPath(); cx.arc(q[0], q[1], 5, 0, 6.3); cx.fill();
    }}
  }});
  let h = '<tr><th>player</th><th>cost</th></tr>';
  D.costs[it].forEach((c, p) => {{
    h += `<tr><td style="color:${{colors[p % colors.length]}}">P${{p + 1}}` +
         `</td><td>${{c.toFixed(3)}}</td></tr>`;
  }});
  document.getElementById('costs').innerHTML = h;
  document.getElementById('conv').textContent =
    'converged: ' + D.converged[it];
  ccx.clearRect(0, 0, cc.width, cc.height);
  const all = D.costs.flat();
  const cmax = Math.max(...all), cmin = Math.min(...all);
  for (let p = 0; p < D.costs[0].length; ++p) {{
    ccx.strokeStyle = colors[p % colors.length];
    ccx.beginPath();
    D.costs.forEach((row, i) => {{
      const x = i / Math.max(D.costs.length - 1, 1) * cc.width;
      const y = cc.height - (row[p] - cmin) / (cmax - cmin + 1e-9)
                * (cc.height - 8) - 4;
      i ? ccx.lineTo(x, y) : ccx.moveTo(x, y);
    }});
    ccx.stroke();
  }}
  ccx.strokeStyle = '#888';
  const xv = (+itS.value) / Math.max(D.costs.length - 1, 1) * cc.width;
  ccx.beginPath(); ccx.moveTo(xv, 0); ccx.lineTo(xv, cc.height);
  ccx.stroke();
}}
// ---- cost inspector (reference gui/cost_inspector.h:62-100): stage
// value of one selected cost over the horizon at the current iterate.
const plS = document.getElementById('pl'), cnS = document.getElementById('cn');
const ci = document.getElementById('ci'), cix = ci.getContext('2d');
function fillCostNames() {{
  const p = +plS.value;
  const names = Object.keys(D.stage_costs[0][p]);
  cnS.innerHTML = names.map(n => `<option>${{n}}</option>`).join('');
}}
function drawInspector() {{
  if (!D.stage_costs) return;
  const it = +itS.value, k = +tkS.value, p = +plS.value;
  const vals = D.stage_costs[it][p][cnS.value];
  if (!vals) return;
  cix.clearRect(0, 0, ci.width, ci.height);
  const vmax = Math.max(...vals), vmin = Math.min(...vals);
  cix.strokeStyle = colors[p % colors.length];
  cix.beginPath();
  vals.forEach((v, i) => {{
    const x = i / Math.max(vals.length - 1, 1) * ci.width;
    const y = ci.height - (v - vmin) / (vmax - vmin + 1e-12)
              * (ci.height - 8) - 4;
    i ? cix.lineTo(x, y) : cix.moveTo(x, y);
  }});
  cix.stroke();
  cix.strokeStyle = '#888';
  const xk = k / Math.max(vals.length - 1, 1) * ci.width;
  cix.beginPath(); cix.moveTo(xk, 0); cix.lineTo(xk, ci.height);
  cix.stroke();
  cix.fillStyle = '#444'; cix.font = '10px sans-serif';
  cix.fillText(vmax.toExponential(2), 2, 10);
  cix.fillText(vmin.toExponential(2), 2, ci.height - 2);
}}
if (D.stage_costs) {{
  document.getElementById('inspwrap').style.display = '';
  plS.innerHTML = D.stage_costs[0].map(
    (_, p) => `<option value="${{p}}">P${{p + 1}}</option>`).join('');
  fillCostNames();
  plS.onchange = () => {{ fillCostNames(); drawInspector(); }};
  cnS.onchange = drawInspector;
}}
const redraw = () => {{ draw(); drawInspector(); }};
itS.oninput = redraw; tkS.oninput = redraw; redraw();
</script></body></html>
"""


def render_html(
    problem,
    log: SolverLog,
    path: str,
    title: Optional[str] = None,
    lanes: Optional[list] = None,
    cost_inspector: bool = True,
) -> str:
    """Write a self-contained scrubable HTML animation of the whole solve
    history to `path`. Returns the path. `lanes`: optional list of
    (M, 2) polylines drawn as road geometry. With `cost_inspector`, every
    named cost's stage values are embedded (via PlayerCostCache) and a
    selector + time-crosshair chart mirrors the reference's CostInspector
    (gui/cost_inspector.h:62-100)."""
    tracks = []
    for op in log.operating_points:
        xs = np.asarray(op.xs)
        players = []
        for (x, y, th) in _agent_xy_theta(problem, xs):
            rec = {"x": np.round(x, 3).tolist(),
                   "y": np.round(y, 3).tolist()}
            if th is not None:
                rec["th"] = np.round(th, 3).tolist()
            players.append(rec)
        tracks.append(players)

    allx = np.concatenate(
        [np.asarray(p["x"]) for it in tracks for p in it]
        + [np.asarray(p["y"]) for it in tracks for p in it]
    )
    lo, hi = float(allx.min()) - 5.0, float(allx.max()) + 5.0

    stage_costs = None
    if cost_inspector:
        from ilqgames_tpu_torch.utils.cost_cache import PlayerCostCache

        cache = PlayerCostCache(problem, log)
        stage_costs = [
            [
                {name: np.round(cache.evaluate(it, p, name), 5).tolist()
                 for name in cache.names(p)}
                for p in range(len(problem.player_costs))
            ]
            for it in range(log.num_iterates)
        ]

    data = {
        "tracks": tracks,
        "costs": [np.asarray(c).tolist() for c in log.total_costs],
        "converged": [bool(c) for c in log.was_converged],
        "dt": float(problem.spec.dt),
        "lo": lo,
        "hi": hi,
        "lanes": [np.asarray(l)[:, :2].clip(lo, hi).round(2).tolist()
                  for l in (lanes or [])],
        "stage_costs": stage_costs,
    }
    html = _TEMPLATE.format(
        title=title or problem.name,
        max_it=log.num_iterates - 1,
        max_k=problem.spec.num_time_steps - 1,
        data=json.dumps(data),
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
