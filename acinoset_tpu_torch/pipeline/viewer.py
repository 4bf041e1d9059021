"""Interactive 3D reconstruction viewer as one standalone HTML file, the
counterpart of acinoset_tpu.pipeline.viewer.

The trajectory is embedded as JSON in a self-contained HTML page with a
small canvas renderer in plain JavaScript: drag to orbit, scroll to
zoom, a slider and play button to scrub frames, camera frusta from the
scene. It opens in any browser, with no server and no GUI stack; the
page is the JAX package's, byte for byte, for the same data. numpy and
json only.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

#: cheetah skeleton edges (marker-index pairs) for rendering
CHEETAH_LINKS = [
    ("nose", "l_eye"), ("nose", "r_eye"), ("l_eye", "r_eye"),
    ("nose", "neck_base"), ("neck_base", "spine"), ("spine", "tail_base"),
    ("tail_base", "tail1"), ("tail1", "tail2"),
    ("neck_base", "l_shoulder"), ("l_shoulder", "l_front_knee"),
    ("l_front_knee", "l_front_ankle"),
    ("neck_base", "r_shoulder"), ("r_shoulder", "r_front_knee"),
    ("r_front_knee", "r_front_ankle"),
    ("tail_base", "l_hip"), ("l_hip", "l_back_knee"), ("l_back_knee", "l_back_ankle"),
    ("tail_base", "r_hip"), ("r_hip", "r_back_knee"), ("r_back_knee", "r_back_ankle"),
]


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>acinoset-tpu 3D viewer</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px}
 #bar{position:fixed;bottom:8px;left:8px;right:8px;display:flex;gap:8px;align-items:center}
 #frame{flex:1}
 canvas{display:block}
 button{background:#333;color:#ddd;border:1px solid #555;padding:2px 10px}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">acinoset-tpu — drag: orbit &nbsp; shift-drag: pan &nbsp; wheel: zoom</div>
<div id="bar"><button id="play">&#9654;</button>
<input type="range" id="frame" min="0" value="0"><span id="lbl"></span></div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const slider = document.getElementById('frame'), lbl = document.getElementById('lbl');
const playBtn = document.getElementById('play');
slider.max = DATA.positions.length - 1;
let yaw = -1.0, pitch = -0.35, dist = null, target = null, playing = false, fi = 0;
let panX = 0, panY = 0;
function bounds(){
  let mn=[1e9,1e9,1e9], mx=[-1e9,-1e9,-1e9];
  for(const fr of DATA.positions) for(const p of fr){
    if(!isFinite(p[0])) continue;
    for(let k=0;k<3;k++){mn[k]=Math.min(mn[k],p[k]);mx[k]=Math.max(mx[k],p[k]);}
  }
  if (DATA.cameras) for(const c of DATA.cameras)
    for(let k=0;k<3;k++){mn[k]=Math.min(mn[k],c.pos[k]);mx[k]=Math.max(mx[k],c.pos[k]);}
  target=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
  dist=2.2*Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1.0);
}
bounds();
function proj(p){
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  let x=p[0]-target[0], y=p[1]-target[1], z=p[2]-target[2];
  let x1=cy*x+sy*y, y1=-sy*x+cy*y;            // yaw about z
  let y2=cp*y1-sp*z, z2=sp*y1+cp*z;           // pitch
  const d=dist/(dist+y2+1e-6);
  const s=Math.min(cv.width,cv.height)/2.2;
  return [cv.width/2+panX+x1*d*s/dist*2.2, cv.height/2+panY-z2*d*s/dist*2.2, d];
}
function draw(){
  cv.width=innerWidth; cv.height=innerHeight;
  ctx.fillStyle='#111'; ctx.fillRect(0,0,cv.width,cv.height);
  // ground grid
  ctx.strokeStyle='#233'; ctx.lineWidth=1;
  const g=Math.ceil(dist/2);
  for(let i=-g;i<=g;i++){
    let a=proj([target[0]+i,target[1]-g,0]), b=proj([target[0]+i,target[1]+g,0]);
    ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]); ctx.stroke();
    a=proj([target[0]-g,target[1]+i,0]); b=proj([target[0]+g,target[1]+i,0]);
    ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]); ctx.stroke();
  }
  if (DATA.cameras) for(const cam of DATA.cameras){
    const o=proj(cam.pos); ctx.fillStyle='#fa0';
    ctx.fillRect(o[0]-3,o[1]-3,6,6);
    ctx.strokeStyle='#a82'; for(const c of cam.frustum){
      const q=proj(c); ctx.beginPath(); ctx.moveTo(o[0],o[1]); ctx.lineTo(q[0],q[1]); ctx.stroke();
    }
  }
  const fr=DATA.positions[fi];
  // trace of a root marker over time
  ctx.strokeStyle='#46a'; ctx.beginPath(); let first=true;
  for(let t=0;t<=fi;t++){
    const p=DATA.positions[t][DATA.trace_idx];
    if(!isFinite(p[0])) continue;
    const q=proj(p); if(first){ctx.moveTo(q[0],q[1]); first=false;} else ctx.lineTo(q[0],q[1]);
  }
  ctx.stroke();
  ctx.strokeStyle='#6cf'; ctx.lineWidth=2;
  for(const [a,b] of DATA.links){
    const p=fr[a], q=fr[b];
    if(!isFinite(p[0])||!isFinite(q[0])) continue;
    const u=proj(p), v=proj(q);
    ctx.beginPath(); ctx.moveTo(u[0],u[1]); ctx.lineTo(v[0],v[1]); ctx.stroke();
  }
  // 1-sigma posterior error bars (world-radius -> screen px at depth)
  if (DATA.std){
    const st=DATA.std[fi], pxPerWorld=Math.min(cv.width,cv.height)/2.2/dist*2.2;
    ctx.strokeStyle='rgba(120,200,255,0.45)';
    for(let l=0;l<fr.length;l++){
      const p=fr[l]; if(!isFinite(p[0])||!st[l]) continue;
      const q=proj(p), r=2*st[l]*pxPerWorld*q[2];  // 2-sigma circle
      ctx.beginPath(); ctx.arc(q[0],q[1],Math.max(r,1),0,6.3); ctx.stroke();
    }
  }
  ctx.fillStyle='#fff';
  for(const p of fr){ if(!isFinite(p[0])) continue; const q=proj(p);
    ctx.beginPath(); ctx.arc(q[0],q[1],3*q[2],0,6.3); ctx.fill(); }
  lbl.textContent=`frame ${fi+1}/${DATA.positions.length}`;
}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup=()=>drag=null;
onmousemove=e=>{ if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){ panX+=dx; panY+=dy; } else { yaw+=dx*0.008; pitch+=dy*0.008; }
  drag=[e.clientX,e.clientY,drag[2]]; draw(); };
cv.onwheel=e=>{ dist*=Math.exp(e.deltaY*0.001); draw(); e.preventDefault(); };
slider.oninput=()=>{ fi=+slider.value; draw(); };
playBtn.onclick=()=>{ playing=!playing; playBtn.innerHTML=playing?'&#9646;&#9646;':'&#9654;'; };
setInterval(()=>{ if(playing){ fi=(fi+1)%DATA.positions.length; slider.value=fi; draw(); } }, 1000/__FPS__);
onresize=draw; draw();
</script></body></html>
"""


def export_interactive_html(
    positions: np.ndarray,  # (N, L, 3)
    out_fpath: str,
    markers: Optional[Sequence[str]] = None,
    links: Optional[Sequence[Sequence[int]]] = None,
    scene: Optional[tuple] = None,  # (k_arr, d_arr, r_arr, t_arr)
    fps: float = 30.0,
    trace_marker: str = "nose",
    marker_std: Optional[np.ndarray] = None,  # (N, L, 3) 1-sigma meters
) -> str:
    """Write a self-contained interactive HTML viewer for a trajectory.

    ``links`` are marker-index pairs; by default the cheetah skeleton
    edges are resolved against ``markers`` by name. ``scene`` draws
    camera positions/frusta (world pose from R, T as in the scene JSON).
    ``marker_std`` (from the FTE Laplace posterior, `fte --uncertainty`)
    draws a translucent 2-sigma circle around each marker, scaled with
    the view. Returns the output path.
    """
    positions = np.asarray(positions, np.float64)
    N, L, _ = positions.shape
    if links is None:
        if markers:
            idx = {m: i for i, m in enumerate(markers)}
            links = [[idx[a], idx[b]] for a, b in CHEETAH_LINKS
                     if a in idx and b in idx]
        else:
            links = []
    cameras = None
    if scene is not None:
        k_arr, _d, r_arr, t_arr = scene
        cameras = []
        for r, t in zip(np.asarray(r_arr), np.asarray(t_arr).reshape(-1, 3)):
            pos = (-np.asarray(r).T @ np.asarray(t)).tolist()
            # small frustum: 4 rays along the optical axis corners
            corners = []
            for u, v in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                d = np.asarray(r).T @ np.array([0.25 * u, 0.25 * v, 1.0])
                corners.append((np.asarray(pos) + 0.8 * d).tolist())
            cameras.append(dict(pos=pos, frustum=corners))
    trace_idx = 0
    if markers and trace_marker in markers:
        trace_idx = list(markers).index(trace_marker)
    std = None
    if marker_std is not None:
        # scalar per marker per frame: RMS of the 3 axis stds
        std = np.sqrt(np.mean(np.asarray(marker_std, np.float64) ** 2, axis=-1))
        std = np.where(np.isfinite(std), std, 0.0).tolist()
    payload = dict(
        positions=positions.tolist(),
        links=[list(map(int, l)) for l in links],
        cameras=cameras,
        trace_idx=int(trace_idx),
        std=std,
    )
    # NaN is a valid JS literal inside the inlined object (the renderer
    # skips non-finite points), so allow_nan stays on
    html = _TEMPLATE.replace("__DATA__", json.dumps(payload)).replace(
        "__FPS__", str(float(fps))
    )
    os.makedirs(os.path.dirname(os.path.abspath(out_fpath)), exist_ok=True)
    with open(out_fpath, "w") as f:
        f.write(html)
    return out_fpath
