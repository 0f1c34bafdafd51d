"""Scene export: PLY point clouds, COLMAP-format cameras/points, and a
self-contained interactive HTML viewer.

The port's own copy of trajectorycrafter_tpu/utils/export.py (plain numpy):
the same files, byte for byte (tests/test_torch_autoregressive.py holds
them together).  The PLY and COLMAP point rows are formatted in bulk, many
rows to one ``%`` of a repeated format, which gives the bytes the JAX
package's row loop writes (each float through Python's ``%.6f``, each colour
as an integer) at a fraction of its time: the autoregressive v2 scene holds
4 M points.
"""

from __future__ import annotations

import base64
import os
from typing import Optional, Sequence

import numpy as np

_ROWS_PER_WRITE = 1 << 16


def _write_rows(f, fmt: str, columns: Sequence[np.ndarray]) -> None:
    """Write one ``fmt`` line per row of ``columns`` (1-D arrays of one
    length, taken as Python floats: ``%.6f`` formats them as the JAX
    package's f-strings of numpy scalars do, ``%d`` writes an integer)."""
    table = np.stack([np.asarray(c, np.float64) for c in columns], axis=1)
    for lo in range(0, len(table), _ROWS_PER_WRITE):
        chunk = table[lo:lo + _ROWS_PER_WRITE]
        f.write((fmt * len(chunk)) % tuple(chunk.ravel().tolist()))


def save_ply(path: str, points: np.ndarray, colors: np.ndarray) -> None:
    """Binary-less ascii PLY (points (N,3) float, colors (N,3) in [0,1])."""
    points = np.asarray(points, np.float32)
    colors = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        _write_rows(f, "%.6f %.6f %.6f %d %d %d\n",
                    [*points.reshape(-1, 3).T, *colors.reshape(-1, 3).T])


def _rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP quaternion (w, x, y, z)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * (1 if q[0] >= 0 else -1)


def save_colmap(
    out_dir: str,
    intrinsics: Sequence[np.ndarray],  # per-image (3, 3)
    c2ws: Sequence[np.ndarray],  # per-image (4, 4)
    width: int,
    height: int,
    points: np.ndarray = None,
    colors: np.ndarray = None,
    max_points: int = 200_000,
) -> None:
    """Write cameras.txt / images.txt / points3D.txt (COLMAP text model)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[fx fy cx cy]\n")
        for i, K in enumerate(intrinsics):
            K = np.asarray(K)
            f.write(f"{i + 1} PINHOLE {width} {height} "
                    f"{K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]}\n")
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for i, c2w in enumerate(c2ws):
            w2c = np.linalg.inv(np.asarray(c2w))
            q = _rotmat_to_qvec(w2c[:3, :3])
            t = w2c[:3, 3]
            f.write(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} {i + 1} frame_{i:05d}.png\n\n")
    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
        if points is not None:
            pts = np.asarray(points)
            cols = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
            if len(pts) > max_points:
                sel = np.random.default_rng(0).choice(len(pts), max_points,
                                                      replace=False)
                pts, cols = pts[sel], cols[sel]
            _write_rows(f, "%d %.6f %.6f %.6f %d %d %d 0.0\n",
                        [np.arange(1, len(pts) + 1), *pts.reshape(-1, 3).T,
                         *cols.reshape(-1, 3).T])


# ----------------------------------------------------------------------------
# Self-contained interactive HTML viewer (viser-notebook replacement)
# ----------------------------------------------------------------------------

_VIEWER_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>trajectorycrafter-tpu scene</title>
<style>
  html,body{margin:0;height:100%;overflow:hidden;background:#101014;
    font:12px/1.4 system-ui,sans-serif;color:#ddd}
  #c{width:100%;height:100%;display:block}
  #hud{position:fixed;left:10px;top:10px;background:rgba(16,16,20,.8);
    padding:8px 10px;border-radius:6px;pointer-events:none;white-space:pre}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">drag: orbit | shift-drag: pan | wheel: zoom | f: frusta | t: trajectory
__NPTS__ points, __NCAM__ cameras</div>
<script>
"use strict";
const b64bytes = s => Uint8Array.from(atob(s), ch => ch.charCodeAt(0));
const PTS = new Float32Array(b64bytes("__PTS_B64__").buffer);
const COL = b64bytes("__COL_B64__");
const CAMS = __CAMS_JSON__;          // per-camera [[4x4 c2w rows], fov_y]
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias: true});
const VS = `attribute vec3 p; attribute vec3 col; uniform mat4 mvp;
  uniform float psize; varying vec3 vc;
  void main(){ gl_Position = mvp * vec4(p, 1.0);
    gl_PointSize = max(psize / max(gl_Position.w, 0.1), 1.0); vc = col; }`;
const FS = `precision mediump float; varying vec3 vc; uniform float flat_;
  void main(){ gl_FragColor = vec4(mix(vc, vec3(1.0,0.85,0.3), flat_), 1.0); }`;
function shader(type, src){ const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s);
  if(!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s); return s; }
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const loc = {p: gl.getAttribLocation(prog, "p"),
  col: gl.getAttribLocation(prog, "col"),
  mvp: gl.getUniformLocation(prog, "mvp"),
  psize: gl.getUniformLocation(prog, "psize"),
  flat_: gl.getUniformLocation(prog, "flat_")};
// point buffers
const pbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, pbuf);
gl.bufferData(gl.ARRAY_BUFFER, PTS, gl.STATIC_DRAW);
const cbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, cbuf);
gl.bufferData(gl.ARRAY_BUFFER, COL, gl.STATIC_DRAW);
// frusta + trajectory line buffers
function frustumLines(){ const v = [];
  for(const [m, fov] of CAMS){
    const z = 0.25, y = Math.tan(fov / 2) * z, x = y * 1.5;
    const cor = [[-x,-y,z],[x,-y,z],[x,y,z],[-x,y,z]];
    const tf = q => { const [a,b,c] = q; return [
      m[0][0]*a+m[0][1]*b+m[0][2]*c+m[0][3],
      m[1][0]*a+m[1][1]*b+m[1][2]*c+m[1][3],
      m[2][0]*a+m[2][1]*b+m[2][2]*c+m[2][3]]; };
    const o = tf([0,0,0]), c4 = cor.map(tf);
    for(let i = 0; i < 4; i++){ v.push(...o, ...c4[i]);
      v.push(...c4[i], ...c4[(i+1)%4]); } }
  return new Float32Array(v); }
function trajLines(){ const v = [];
  for(let i = 0; i + 1 < CAMS.length; i++){
    const a = CAMS[i][0], b = CAMS[i+1][0];
    v.push(a[0][3], a[1][3], a[2][3], b[0][3], b[1][3], b[2][3]); }
  return new Float32Array(v); }
const fr = frustumLines(), tr = trajLines();
const fbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, fbuf);
gl.bufferData(gl.ARRAY_BUFFER, fr, gl.STATIC_DRAW);
const tbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, tbuf);
gl.bufferData(gl.ARRAY_BUFFER, tr, gl.STATIC_DRAW);
// scene bounds -> initial orbit target/radius
let cx = 0, cy = 0, cz = 0, n = PTS.length / 3;
for(let i = 0; i < PTS.length; i += 3){ cx += PTS[i]; cy += PTS[i+1]; cz += PTS[i+2]; }
if(n > 0){ cx /= n; cy /= n; cz /= n; }
let r0 = 1e-6;
for(let i = 0; i < PTS.length; i += 3){
  const d = Math.hypot(PTS[i]-cx, PTS[i+1]-cy, PTS[i+2]-cz);
  if(d > r0) r0 = d; }
let target = [cx, cy, cz], dist = r0 * 2.0 || 5, theta = -0.4, phi = 0.5;
let showFr = true, showTr = true;
// mat helpers (column-major out)
function perspective(fovy, asp, near, far){ const f = 1 / Math.tan(fovy / 2);
  return [f/asp,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1,
          0,0,2*far*near/(near-far),0]; }
function lookAt(eye, ctr, up){
  const z = norm3(sub3(eye, ctr)), x = norm3(cross3(up, z)), y = cross3(z, x);
  return [x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
          -dot3(x,eye),-dot3(y,eye),-dot3(z,eye),1]; }
function matmul4(a, b){ const o = new Array(16).fill(0);
  for(let i = 0; i < 4; i++) for(let j = 0; j < 4; j++)
    for(let k = 0; k < 4; k++) o[j*4+i] += a[k*4+i]*b[j*4+k];
  return o; }
const sub3=(a,b)=>[a[0]-b[0],a[1]-b[1],a[2]-b[2]];
const dot3=(a,b)=>a[0]*b[0]+a[1]*b[1]+a[2]*b[2];
const cross3=(a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];
const norm3=a=>{const l=Math.hypot(...a)||1;return [a[0]/l,a[1]/l,a[2]/l];};
function draw(){
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if(canvas.width !== w || canvas.height !== h){ canvas.width = w; canvas.height = h; }
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.063, 0.063, 0.078, 1); gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const eye = [target[0] + dist*Math.cos(phi)*Math.sin(theta),
               target[1] + dist*Math.sin(phi),
               target[2] + dist*Math.cos(phi)*Math.cos(theta)];
  const mvp = matmul4(perspective(1.0, w/h, dist*0.01, dist*100),
                      lookAt(eye, target, [0, 1, 0]));
  gl.uniformMatrix4fv(loc.mvp, false, mvp);
  // points
  gl.uniform1f(loc.flat_, 0); gl.uniform1f(loc.psize, 4.0 * dist / (r0*2 || 1));
  gl.bindBuffer(gl.ARRAY_BUFFER, pbuf);
  gl.enableVertexAttribArray(loc.p);
  gl.vertexAttribPointer(loc.p, 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, cbuf);
  gl.enableVertexAttribArray(loc.col);
  gl.vertexAttribPointer(loc.col, 3, gl.UNSIGNED_BYTE, true, 0, 0);
  gl.drawArrays(gl.POINTS, 0, n);
  // frusta / trajectory as flat-colored lines
  gl.disableVertexAttribArray(loc.col);
  gl.vertexAttrib3f(loc.col, 1, 1, 1); gl.uniform1f(loc.flat_, 1);
  if(showFr && fr.length){ gl.bindBuffer(gl.ARRAY_BUFFER, fbuf);
    gl.vertexAttribPointer(loc.p, 3, gl.FLOAT, false, 0, 0);
    gl.drawArrays(gl.LINES, 0, fr.length / 3); }
  if(showTr && tr.length){ gl.bindBuffer(gl.ARRAY_BUFFER, tbuf);
    gl.vertexAttribPointer(loc.p, 3, gl.FLOAT, false, 0, 0);
    gl.drawArrays(gl.LINES, 0, tr.length / 3); }
  requestAnimationFrame(draw); }
let drag = null;
canvas.addEventListener("mousedown", e => drag = [e.clientX, e.clientY, e.shiftKey]);
window.addEventListener("mouseup", () => drag = null);
window.addEventListener("mousemove", e => { if(!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if(drag[2]){ const s = dist * 0.002;
    const right = [Math.cos(theta), 0, -Math.sin(theta)];
    target[0] -= right[0]*dx*s; target[2] -= right[2]*dx*s; target[1] += dy*s;
  } else { theta -= dx * 0.005;
    phi = Math.min(1.55, Math.max(-1.55, phi + dy * 0.005)); }
  drag = [e.clientX, e.clientY, drag[2]]; });
canvas.addEventListener("wheel", e => { e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001); }, {passive: false});
window.addEventListener("keydown", e => {
  if(e.key === "f") showFr = !showFr;
  if(e.key === "t") showTr = !showTr; });
requestAnimationFrame(draw);
</script></body></html>
"""


def save_html_viewer(
    path: str,
    points: np.ndarray,  # (N, 3)
    colors: np.ndarray,  # (N, 3) in [0, 1]
    c2ws: Optional[Sequence[np.ndarray]] = None,  # per-camera (4, 4)
    intrinsics: Optional[Sequence[np.ndarray]] = None,  # per-camera (3, 3)
    height: int = 576,
    max_points: int = 400_000,
) -> None:
    """Write a single self-contained HTML file with an interactive WebGL
    viewer of the global point cloud + camera frusta + trajectory polyline.

    Replaces the reference's viser notebooks
    (notebooks/28_08_25_trajectories/viser_utils.py:1): no server, no CDN,
    no dependency -- any browser opens the artifact directly (zero-egress
    friendly).  Clouds above ``max_points`` are subsampled deterministically.
    """
    points = np.asarray(points, np.float32).reshape(-1, 3)
    colors = np.clip(np.asarray(colors, np.float32).reshape(-1, 3), 0.0, 1.0)
    if len(points) > max_points:
        sel = np.random.default_rng(0).choice(len(points), max_points,
                                              replace=False)
        points, colors = points[sel], colors[sel]
    cams = []
    if c2ws is not None:
        for i, c2w in enumerate(c2ws):
            c2w = np.asarray(c2w, np.float64)
            if intrinsics is not None:
                fy = float(np.asarray(intrinsics[i])[1, 1])
                fov = 2.0 * np.arctan(0.5 * height / max(fy, 1e-6))
            else:
                fov = 0.9
            cams.append([[[round(float(v), 6) for v in row] for row in c2w],
                         round(float(fov), 6)])
    import json

    html = (
        _VIEWER_TEMPLATE
        .replace("__PTS_B64__", base64.b64encode(points.tobytes()).decode())
        .replace("__COL_B64__",
                 base64.b64encode((colors * 255).astype(np.uint8).tobytes()).decode())
        .replace("__CAMS_JSON__", json.dumps(cams))
        .replace("__NPTS__", str(len(points)))
        .replace("__NCAM__", str(len(cams)))
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
