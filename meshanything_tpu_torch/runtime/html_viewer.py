"""A standalone interactive HTML mesh viewer: a JAX-free copy of
``meshanything_tpu/runtime/html_viewer.py``, whose output it equals byte
for byte.

The reference vendors a PyThreeJSViewer (utils/visualizers/
pythreejs_viewer.py:12 + html_util.py) that needs a live Jupyter kernel
and the three.js stack. This is a self-contained HTML file instead: the
mesh as JSON plus a ~100-line pure-JS software renderer (painter's
algorithm flat shading + wireframe on a <canvas>, mouse-drag orbit, wheel
zoom). No network, no dependencies.
"""
from __future__ import annotations

import json

import numpy as np

_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin:0; background:#1b1b1f; color:#ddd; font:13px sans-serif; }}
 #hud {{ position:fixed; top:8px; left:10px; }}
 canvas {{ display:block; }}
</style></head>
<body>
<div id="hud">{title} — {nv} vertices, {nf} faces. drag to orbit, wheel to zoom, w toggles wireframe</div>
<canvas id="c"></canvas>
<script>
const V = {vertices};
const F = {faces};
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let yaw = 0.7, pitch = 0.4, dist = 2.6, wire = false;

function resize() {{ canvas.width = innerWidth; canvas.height = innerHeight; draw(); }}
addEventListener('resize', resize);

let drag = null;
canvas.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {{
  if (!drag) return;
  yaw += (e.clientX - drag[0]) * 0.01;
  pitch = Math.max(-1.5, Math.min(1.5, pitch + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
  draw();
}});
canvas.addEventListener('wheel', e => {{ dist *= Math.exp(e.deltaY * 0.001); draw(); e.preventDefault(); }});
addEventListener('keydown', e => {{ if (e.key === 'w') {{ wire = !wire; draw(); }} }});

function draw() {{
  const w = canvas.width, h = canvas.height, s = Math.min(w, h) * 0.8;
  ctx.fillStyle = '#1b1b1f'; ctx.fillRect(0, 0, w, h);
  const cy = Math.cos(yaw), sy = Math.sin(yaw), cp = Math.cos(pitch), sp = Math.sin(pitch);
  const pts = V.map(v => {{
    const x = v[0] * cy + v[2] * sy;
    const z = -v[0] * sy + v[2] * cy;
    const y = v[1] * cp - z * sp;
    const z2 = v[1] * sp + z * cp + dist;
    return [w / 2 + s * x / z2, h / 2 - s * y / z2, z2];
  }});
  const tris = F.map(f => {{
    const a = pts[f[0]], b = pts[f[1]], c = pts[f[2]];
    return [f, (a[2] + b[2] + c[2]) / 3];
  }}).sort((p, q) => q[1] - p[1]);
  for (const [f, _] of tris) {{
    const a = pts[f[0]], b = pts[f[1]], c = pts[f[2]];
    const nx = (b[0]-a[0])*(c[1]-a[1]) - (b[1]-a[1])*(c[0]-a[0]);
    const shade = Math.max(0.25, Math.min(1, 0.4 + 0.6 * (nx > 0 ? 1 : 0.3)));
    ctx.beginPath();
    ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]); ctx.lineTo(c[0], c[1]);
    ctx.closePath();
    if (!wire) {{
      ctx.fillStyle = `rgba(${{Math.round(255*shade)}}, ${{Math.round(165*shade)}}, 0, 1)`;
      ctx.fill();
    }}
    ctx.strokeStyle = wire ? '#ffa500' : 'rgba(60,30,5,0.8)';
    ctx.lineWidth = 0.5;
    ctx.stroke();
  }}
}}
resize();
</script></body></html>
"""



def export_html_viewer(vertices: np.ndarray, faces: np.ndarray, out_path: str,
                       title: str = "meshanything_tpu") -> str:
    """Write a dependency-free interactive viewer for one mesh; the
    vertices are normalized to the unit sphere, so any scale views."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    if len(v):
        center = (v.min(axis=0) + v.max(axis=0)) / 2
        scale = max(float(np.abs(v - center).max()), 1e-9)
        v = (v - center) / scale
    html = _TEMPLATE.format(
        title=title,
        nv=len(v),
        nf=len(f),
        vertices=json.dumps(np.round(v, 5).tolist()),
        faces=json.dumps(f.tolist()),
    )
    with open(out_path, "w") as fh:
        fh.write(html)
    return out_path
