"""Interactive map viewer — self-contained HTML export.

The reference runs a live Pangolin window (``src/viewer.cc:156-188``) with
a menu of toggles (Follow Camera / Show Points / Show KeyFrames / Show
Graph), frame stepping and pause. This environment is headless, so the
TPU build provides the same interaction surface as a single offline HTML
file: the map (points, keyframe frusta, covisibility graph, loop edges)
and the full per-frame trajectory are embedded as JSON and rendered by a
hand-written canvas renderer — no external libraries, works from file://
with zero network. Controls mirror the reference menu:

* orbit (drag), pan (shift-drag / right-drag), zoom (wheel);
* play / pause / step through the tracked frames (space, ←/→ keys);
* Follow Camera mode (the viewer tracks the current frame's pose);
* Show Points / KeyFrames / Graph / Trajectory / Loop-edge toggles.

``System.save_interactive_viewer(path)`` exports the live session.

Counterpart of ``orb_slam_fusion_tpu/viz/viewer.py``: the same page, and
for the same map the same embedded ``const D={...}`` JSON (the payload is
computed in numpy from the map's host copy, as the reference does).
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np

from ..map import map_state as ms
from .drawers import _host


def _map_payload(m: ms.MapState, max_points: int, cov_min: int):
    valid = _host(m.mp_valid)
    pts = _host(m.mp_pos)[valid]
    if len(pts) > max_points:          # decimate evenly, keep shape
        pts = pts[:: int(np.ceil(len(pts) / max_points))]
    n_kf = int(m.n_kf)
    kf_valid = _host(m.kf_valid)[:n_kf]
    R = _host(m.kf_pose.R)[:n_kf]
    t = _host(m.kf_pose.t)[:n_kf]
    # frustum geometry precomputed host-side: apex + 4 image-plane corners
    Rwc = np.transpose(R, (0, 2, 1))
    C = -np.einsum("kij,kj->ki", Rwc, t)
    s = 0.15
    corners = np.array([[0.8 * s, 0.5 * s, s], [0.8 * s, -0.5 * s, s],
                        [-0.8 * s, -0.5 * s, s], [-0.8 * s, 0.5 * s, s]])
    frusta = C[:, None, :] + np.einsum("kij,cj->kci", Rwc, corners)
    cov_pairs = []
    if n_kf > 1:
        W = _host(ms.covisibility_matrix(m))[:n_kf, :n_kf]
        ii, jj = np.where(np.triu(W, 1) >= cov_min)
        keep = kf_valid[ii] & kf_valid[jj]
        cov_pairs = np.stack([ii[keep], jj[keep]], 1).tolist()
    return {
        "points": np.round(pts, 3).tolist(),
        "kf_centers": np.round(C, 3).tolist(),
        "kf_frusta": np.round(frusta, 3).tolist(),
        "kf_valid": kf_valid.astype(int).tolist(),
        "cov": cov_pairs,
    }


def export_interactive(m: ms.MapState, path: str,
                       trajectory: Optional[np.ndarray] = None,
                       loop_edges: Optional[Sequence] = None,
                       title: str = "orb_slam_fusion_tpu",
                       max_points: int = 60000,
                       cov_min: int = 30) -> None:
    """Write a self-contained interactive HTML viewer.

    ``trajectory`` is the (N, 8) TUM array (timestamp, t_wc, q_wc) from
    ``tracker.trajectory_tum()``; ``loop_edges`` an iterable of
    ``(kf_i, kf_j, rel)`` as kept by LoopClosing."""
    data = _map_payload(m, max_points, cov_min)
    if trajectory is not None and len(trajectory):
        tr = np.asarray(trajectory)
        data["traj"] = np.round(tr[:, 1:4], 4).tolist()
        data["traj_q"] = np.round(tr[:, 4:8], 5).tolist()
        data["traj_ts"] = np.round(tr[:, 0], 4).tolist()
    else:
        data["traj"], data["traj_q"], data["traj_ts"] = [], [], []
    data["loops"] = [[int(i), int(j)] for i, j, *_ in (loop_edges or [])]
    data["title"] = title
    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(path, "w") as f:
        f.write(html)


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__T__</title><style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:rgba(20,20,25,.85);
      padding:10px 12px;border-radius:8px;line-height:1.8;user-select:none}
 #hud label{margin-right:10px;cursor:pointer}
 #hud button{background:#2a6df4;color:#fff;border:0;border-radius:4px;
      padding:3px 10px;margin-right:6px;cursor:pointer}
 #frame{width:260px;vertical-align:middle}
 #stat{position:fixed;bottom:8px;left:8px;color:#9a9;background:rgba(20,20,25,.7);
      padding:4px 8px;border-radius:6px}
 canvas{display:block}
</style></head><body>
<canvas id="cv"></canvas>
<div id="hud">
 <div><b id="ttl"></b></div>
 <div>
  <button id="play">play</button>
  <button id="stepb">&#9664;</button>
  <button id="stepf">&#9654;</button>
  <input type="range" id="frame" min="0" max="0" value="0">
  <span id="fno"></span>
 </div>
 <div>
  <label><input type="checkbox" id="follow"> follow camera</label>
  <label><input type="checkbox" id="pts" checked> points</label>
  <label><input type="checkbox" id="kfs" checked> keyframes</label>
 </div>
 <div>
  <label><input type="checkbox" id="graph" checked> graph</label>
  <label><input type="checkbox" id="traj" checked> trajectory</label>
  <label><input type="checkbox" id="loopcb" checked> loop edges</label>
 </div>
</div>
<div id="stat"></div>
<script>
const D=__DATA__;
document.getElementById('ttl').textContent=D.title;
const cv=document.getElementById('cv'),cx=cv.getContext('2d');
let yaw=-0.6,pitch=0.45,dist=14,target=[0,0,0],cur=0,playing=false;
const N=D.traj.length;
document.getElementById('frame').max=Math.max(N-1,0);
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw()}
addEventListener('resize',resize);
function rot(){const cy=Math.cos(yaw),sy=Math.sin(yaw),
 cp=Math.cos(pitch),sp=Math.sin(pitch);
 return [[cy,0,-sy],[sy*sp,cp,cy*sp],[sy*cp,-sp,cy*cp]]}
function proj(p,R){const x=p[0]-target[0],y=p[1]-target[1],z=p[2]-target[2];
 const vx=R[0][0]*x+R[0][1]*y+R[0][2]*z, vy=R[1][0]*x+R[1][1]*y+R[1][2]*z,
 vz=R[2][0]*x+R[2][1]*y+R[2][2]*z+dist;
 if(vz<0.05)return null;const f=0.9*Math.min(cv.width,cv.height)/vz;
 return [cv.width/2+f*vx,cv.height/2+f*vy,vz]}
function seg(a,b,R){const A=proj(a,R),B=proj(b,R);
 if(!A||!B)return;cx.beginPath();cx.moveTo(A[0],A[1]);cx.lineTo(B[0],B[1]);
 cx.stroke()}
function draw(){
 const R=rot();cx.fillStyle='#111';cx.fillRect(0,0,cv.width,cv.height);
 if(document.getElementById('pts').checked){cx.fillStyle='#8b8b8b';
  for(const p of D.points){const q=proj(p,R);
   if(q)cx.fillRect(q[0],q[1],1.3,1.3)}}
 if(document.getElementById('kfs').checked){cx.strokeStyle='#3b82f6';
  cx.lineWidth=0.7;
  for(let k=0;k<D.kf_centers.length;k++){if(!D.kf_valid[k])continue;
   const c=D.kf_centers[k],F=D.kf_frusta[k];
   for(let i=0;i<4;i++){seg(c,F[i],R);seg(F[i],F[(i+1)%4],R)}}}
 if(document.getElementById('graph').checked){cx.strokeStyle='rgba(46,160,67,.55)';
  cx.lineWidth=0.5;
  for(const e of D.cov)seg(D.kf_centers[e[0]],D.kf_centers[e[1]],R)}
 if(document.getElementById('loopcb').checked){cx.strokeStyle='#f43f5e';
  cx.lineWidth=1.6;
  for(const e of D.loops)seg(D.kf_centers[e[0]],D.kf_centers[e[1]],R)}
 if(document.getElementById('traj').checked&&N>1){cx.strokeStyle='#e3b341';
  cx.lineWidth=1.4;cx.beginPath();let started=false;
  for(let i=0;i<=cur;i++){const q=proj(D.traj[i],R);
   if(!q){started=false;continue}
   if(!started){cx.moveTo(q[0],q[1]);started=true}else cx.lineTo(q[0],q[1])}
  cx.stroke()}
 if(N){const q=proj(D.traj[cur],R);
  if(q){cx.fillStyle='#f43f5e';cx.beginPath();
   cx.arc(q[0],q[1],5,0,6.283);cx.fill()}}
 document.getElementById('fno').textContent=N?` ${cur+1}/${N}  t=${D.traj_ts[cur]}`:'';
 document.getElementById('stat').textContent=
  `${D.points.length} pts  ${D.kf_centers.length} KFs  ${D.cov.length} cov edges  `+
  `${D.loops.length} loop edges`;
}
function setFrame(i){cur=Math.max(0,Math.min(N-1,i));
 document.getElementById('frame').value=cur;
 if(document.getElementById('follow').checked&&N)target=D.traj[cur].slice();
 draw()}
document.getElementById('frame').oninput=e=>setFrame(+e.target.value);
document.getElementById('stepf').onclick=()=>setFrame(cur+1);
document.getElementById('stepb').onclick=()=>setFrame(cur-1);
const playBtn=document.getElementById('play');
playBtn.onclick=()=>{playing=!playing;playBtn.textContent=playing?'pause':'play';
 if(playing)tick()};
function tick(){if(!playing)return;
 if(cur>=N-1){playing=false;playBtn.textContent='play';return}
 setFrame(cur+1);setTimeout(tick,50)}
addEventListener('keydown',e=>{
 if(e.key===' '){playBtn.onclick();e.preventDefault()}
 else if(e.key==='ArrowRight')setFrame(cur+1);
 else if(e.key==='ArrowLeft')setFrame(cur-1)});
let drag=null;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey||e.button===2]};
cv.oncontextmenu=e=>e.preventDefault();
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){const R=rot(),s=dist*0.0015;
  target[0]-=s*(R[0][0]*dx+R[1][0]*dy);target[1]-=s*(R[0][1]*dx+R[1][1]*dy);
  target[2]-=s*(R[0][2]*dx+R[1][2]*dy)}
 else{yaw+=dx*0.005;pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.005))}
 drag=[e.clientX,e.clientY,drag[2]];draw()});
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);
 dist=Math.max(0.3,Math.min(500,dist));draw();e.preventDefault()};
if(N)target=D.traj[Math.floor(N/2)].slice();
else if(D.kf_centers.length)target=D.kf_centers[0].slice();
resize();
</script></body></html>
"""
_TEMPLATE = _TEMPLATE.replace("__T__", "orb_slam_fusion_tpu viewer")
