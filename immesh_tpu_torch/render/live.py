"""Live mesh viewer: HTTP server streaming dirty regions to a browser — port
of immesh_tpu/render/live.py.

The reference renders its mesh in-process: a GLFW/ImGui window fed by a
100 ms sync thread that copies each region's triangles into a per-region VBO
whenever its `Sync_triangle_set` dirty flag is set (reference
src/meshing/mesh_rec_display.cpp:220-282, region sharding triangle.cpp:35-53).
A compute host is headless, so the equivalent is a tiny HTTP server on the
host:

  * the SAME pull model — per-voxel `TriangleStore.dirty` flags are drained
    into a host-side per-region geometry cache (regions = `region_size`
    cubes, default 10 m, exactly the reference's display shard);
  * the browser polls `/state?since=<seq>`, learns which regions changed,
    and fetches only those as compact binary buffers (`/region/<id>`) into
    per-region GL vertex buffers — the reference's VBO-per-region scheme,
    with HTTP replacing the shared-memory mutex;
  * `/` serves a self-contained WebGL2 orbit viewer (no external assets —
    the host may have no egress).

Everything is stdlib (http.server + threading); the server thread only ever
touches NumPy copies, never device tensors, so it cannot stall the frame
loop.
"""

from __future__ import annotations

import collections
import http.server
import json
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from immesh_tpu_torch.runtime.export import smooth_vertices

_MAGIC = 0x4D455348  # "MESH"


class RegionCache:
    """Host mirror of the triangle store, sharded by display region.

    `sync(gm, store)` drains the dirty voxels (device → host once per call),
    rebuilds the vertex buffers of the touched regions, and returns the
    cleared store.  One region buffer = float32 (n_tris, 3 verts, 3 xyz)."""

    def __init__(self, region_size: float, voxel_resolution: float,
                 smooth_lam: float = 0.8):
        """smooth_lam: display-time Laplacian blend ∈ [0, 1] — the reference
        smooths every DISPLAYED vertex lazily with a kNN mean (get_pos(1),
        mesh_rec_display.cpp:85-97, factor 1.0/k=20 ImMesh_node.cpp:130-131)
        while triangulating on raw positions; here the dirty-subgraph 1-ring
        mean stands in for the kNN set (same op, connectivity we already
        have).  0 disables."""
        self.region_size = float(region_size)
        self.voxel_resolution = float(voxel_resolution)
        self.smooth_lam = float(smooth_lam)
        self._voxel_geom: Dict[int, np.ndarray] = {}   # slot -> (n,3,3) f32
        self._voxel_region: Dict[int, Tuple[int, int, int]] = {}
        # inverse index: region -> member voxel slots, maintained
        # incrementally so a region rebuild touches only its own voxels
        self._region_voxels: Dict[Tuple[int, int, int], set] = {}
        self._regions: Dict[Tuple[int, int, int], np.ndarray] = {}
        self._region_seq: Dict[Tuple[int, int, int], int] = {}
        self.seq = 0
        self.lock = threading.Lock()

    def sync(self, gm, store):
        """Pull dirty voxels' triangles to host; returns store.clear_dirty()
        (the store's flags are cleared in place).

        Mirrors synchronize_triangle_list_for_disp (mesh_rec_display.cpp:220):
        only regions whose voxels re-meshed since the last sync are rebuilt."""
        dirty = store.dirty.cpu().numpy()
        slots = np.nonzero(dirty)[0]
        if slots.size == 0:
            return store
        sl = torch.from_numpy(slots).to(store.dirty.device)
        tri = store.tri_ids[sl].cpu().numpy()
        keys = gm.vox.keys[sl].cpu().numpy()
        flat = tri.reshape(-1, 3)
        valid = np.all(flat >= 0, axis=-1)
        used = np.unique(flat[valid]) if valid.any() else np.zeros(0, np.int64)
        if used.size:
            pts = gm.pts[torch.from_numpy(used).to(gm.pts.device).long()]
            pts = pts.cpu().numpy()
            remap = {int(g): i for i, g in enumerate(used)}
            if self.smooth_lam > 0.0 and valid.any():
                lut = np.full(int(used.max()) + 1, -1, np.int64)
                lut[used] = np.arange(used.size)
                local_tris = lut[flat[valid]]
                pts = smooth_vertices(pts, local_tris, iterations=1,
                                      lam=self.smooth_lam)
        else:
            pts = np.zeros((0, 3), np.float32)
            remap = {}

        scale = self.voxel_resolution / self.region_size
        touched = set()
        with self.lock:
            for i, slot in enumerate(slots):
                t = tri[i]
                ok = np.all(t >= 0, axis=-1)
                t = t[ok]
                if t.size:
                    idx = np.vectorize(remap.__getitem__)(t)
                    geom = pts[idx].astype(np.float32)        # (n, 3, 3)
                else:
                    geom = np.zeros((0, 3, 3), np.float32)
                rid = tuple(int(np.floor(k * scale)) for k in keys[i, :3])
                s_int = int(slot)
                old_rid = self._voxel_region.get(s_int)
                if old_rid is not None and old_rid != rid:
                    touched.add(old_rid)
                    self._region_voxels.get(old_rid, set()).discard(s_int)
                self._voxel_region[s_int] = rid
                self._region_voxels.setdefault(rid, set()).add(s_int)
                self._voxel_geom[s_int] = geom
                touched.add(rid)
            self.seq += 1
            for rid in touched:
                parts = [self._voxel_geom[s]
                         for s in self._region_voxels.get(rid, ())]
                buf = (np.concatenate(parts, axis=0) if parts
                       else np.zeros((0, 3, 3), np.float32))
                self._regions[rid] = buf
                self._region_seq[rid] = self.seq
        return store.clear_dirty()

    # ---- reader side (server thread) ---------------------------------
    def changed_since(self, since: int) -> List[Tuple[int, int, int]]:
        with self.lock:
            return [rid for rid, s in self._region_seq.items() if s > since]

    def region_bytes(self, rid: Tuple[int, int, int]) -> bytes:
        """Binary region buffer: magic, rid xyz, n_tris, then n*9 f32 LE."""
        with self.lock:
            buf = self._regions.get(rid)
            if buf is None:
                buf = np.zeros((0, 3, 3), np.float32)
            head = struct.pack("<Iiiii", _MAGIC, *rid, buf.shape[0])
            return head + buf.astype("<f4").tobytes()

    def stats(self) -> dict:
        with self.lock:
            return {
                "seq": self.seq,
                "n_regions": len(self._regions),
                "n_triangles": int(sum(b.shape[0]
                                       for b in self._regions.values())),
            }


def extract_planes(vm) -> np.ndarray:
    """Live VoxelMap → (M, 8) f32 plane-patch rows
    [center x y z, normal x y z, half_extent, min_eigenvalue].

    The `pubPlaneMap` analogue (reference src/voxel_mapping.cpp:947-1159
    renders the probabilistic voxel planes as a MarkerArray — the main
    debugging view for the LIO map): patch extent follows the voxel level
    (octant children are half-size), color-by-min-eigenvalue happens in the
    viewer."""
    valid = vm.plane_valid.cpu().numpy()
    idx = np.nonzero(valid)[0]
    center = vm.center.cpu().numpy()[idx]
    normal = vm.normal.cpu().numpy()[idx]
    lam = vm.lam.cpu().numpy()[idx]                 # ascending eigenvalues
    level = vm.table.keys.cpu().numpy()[idx, 3].astype(np.float32)
    half = (0.45 * vm.cfg.voxel_size / (2.0 ** level)).astype(np.float32)
    return np.concatenate(
        [center, normal, half[:, None],
         np.maximum(lam[:, :1], 0.0)],     # f32 fit noise can dip < 0
        axis=1
    ).astype(np.float32)


class LiveMeshServer:
    """Threaded HTTP server exposing the region cache + trajectory.

    Usage:
        srv = LiveMeshServer(cache)                # port=0 → ephemeral
        srv.start()                                 # daemon thread
        ... per N frames:  pipe.store = cache.sync(pipe.gm, pipe.store)
                           srv.record_pose(t, pos, quat)
        srv.stop()
    """

    #: runtime-mutable controls and their value coercions — the analogue of
    #: the reference's GUI-mutable parameter set (pause, draw toggles,
    #: follow camera; reference ImMesh_node.cpp:360-432).  The runtime polls
    #: `pause` each frame; the browser viewer applies the draw toggles and
    #: POSTs updates back, so every client and the runtime share one state.
    CONTROL_TYPES = {
        "pause": bool,
        "draw_mesh": bool,
        "draw_traj": bool,
        "draw_planes": bool,
        "follow": bool,
        # runtime-mutable reinforcement parameters (the reference exposes
        # density/depth live in its GUI, ImMesh_node.cpp:305-329); the
        # runtime reads these when it rasterizes reinforcement points
        "reinf_step": int,
        "reinf_max_depth": float,
    }

    def __init__(self, cache: RegionCache, host: str = "127.0.0.1",
                 port: int = 0):
        self.cache = cache
        # bounded: /state only ever serves the trailing window, so keeping
        # more would grow host memory without bound on long runs
        self._traj: "collections.deque" = collections.deque(maxlen=2000)
        self._traj_lock = threading.Lock()
        self._controls = {"pause": False, "draw_mesh": True,
                          "draw_traj": True, "draw_planes": False,
                          "follow": True,
                          "reinf_step": 2, "reinf_max_depth": 80.0}
        self._controls_lock = threading.Lock()
        self._planes = b"\x00\x00\x00\x00"      # i32 count + (M, 8) f32
        self._planes_lock = threading.Lock()
        cache_ref = self.cache
        traj_ref = self._traj
        traj_lock = self._traj_lock
        controls_ref = self._controls
        controls_lock = self._controls_lock
        control_types = self.CONTROL_TYPES
        srv = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):      # silence request spam
                pass

            def _send(self, code, body: bytes, ctype: str):
                # no CORS header: the bundled viewer is same-origin, and a
                # wildcard would let any page in the operator's browser read
                # live location data (riskier still on non-loopback binds)
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/":
                    self._send(200, _VIEWER_HTML.encode(), "text/html")
                elif path == "/state":
                    since = 0
                    for kv in query.split("&"):
                        if kv.startswith("since="):
                            try:
                                since = int(kv[6:])
                            except ValueError:
                                pass
                    st = cache_ref.stats()
                    st["changed"] = [list(r)
                                     for r in cache_ref.changed_since(since)]
                    with traj_lock:
                        st["traj"] = list(traj_ref)
                    self._send(200, json.dumps(st).encode(),
                               "application/json")
                elif path.startswith("/region/"):
                    try:
                        rid = tuple(int(v)
                                    for v in path[len("/region/"):].split(","))
                        assert len(rid) == 3
                    except Exception:
                        self._send(400, b"bad region id", "text/plain")
                        return
                    self._send(200, cache_ref.region_bytes(rid),
                               "application/octet-stream")
                elif path == "/planes":
                    with srv._planes_lock:
                        body = srv._planes
                    self._send(200, body, "application/octet-stream")
                elif path == "/controls":
                    with controls_lock:
                        body = json.dumps(dict(controls_ref)).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                path, _, _ = self.path.partition("?")
                if path != "/controls":
                    self._send(404, b"not found", "text/plain")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    updates = json.loads(self.rfile.read(n) or b"{}")
                    assert isinstance(updates, dict)
                except Exception:
                    self._send(400, b"bad controls body", "text/plain")
                    return
                with controls_lock:
                    for k, v in updates.items():
                        tp = control_types.get(k)
                        if tp is not None:
                            controls_ref[k] = tp(v)
                    body = json.dumps(dict(controls_ref)).encode()
                self._send(200, body, "application/json")

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        h, p = self._server.server_address[:2]
        return f"http://{h}:{p}/"

    # ---- runtime-mutable controls (reference ImMesh_node.cpp:360-432) ----
    @property
    def controls(self) -> dict:
        """Snapshot of the control state (thread-safe copy)."""
        with self._controls_lock:
            return dict(self._controls)

    def set_control(self, key: str, value) -> None:
        tp = self.CONTROL_TYPES.get(key)
        if tp is None:
            raise KeyError(f"unknown control {key!r}")
        with self._controls_lock:
            self._controls[key] = tp(value)

    @property
    def paused(self) -> bool:
        with self._controls_lock:
            return bool(self._controls["pause"])

    def record_pose(self, t: float, pos, quat_xyzw=(0, 0, 0, 1)) -> None:
        with self._traj_lock:
            self._traj.append([float(t)] + [float(v) for v in pos]
                              + [float(v) for v in quat_xyzw])

    def record_planes(self, planes) -> None:
        """Publish the current plane patches ((M, 8) f32, see
        extract_planes) for the viewer's plane-map overlay."""
        arr = np.ascontiguousarray(planes, np.float32)
        body = struct.pack("<i", arr.shape[0]) + arr.tobytes()
        with self._planes_lock:
            self._planes = body

    def start(self) -> "LiveMeshServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)


_VIEWER_HTML = r"""<!doctype html>
<meta charset="utf-8"><title>immesh_tpu live</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#101014}
 #hud{position:fixed;top:8px;left:8px;color:#cfd4dc;
      font:12px/1.5 system-ui,monospace;user-select:none}
 canvas{display:block;width:100vw;height:100vh}
</style>
<div id="hud">immesh_tpu — connecting…</div><canvas id="c"></canvas>
<script>
"use strict";
const cv=document.getElementById("c"),hud=document.getElementById("hud");
const gl=cv.getContext("webgl2",{antialias:true});
const VS=`#version 300 es
layout(location=0) in vec3 p;uniform mat4 mvp,mv;out vec3 vp;
void main(){vp=(mv*vec4(p,1.)).xyz;gl_Position=mvp*vec4(p,1.);}`;
const FS=`#version 300 es
precision highp float;in vec3 vp;out vec4 o;uniform vec3 tint;
void main(){vec3 n=normalize(cross(dFdx(vp),dFdy(vp)));
 float d=abs(n.z)*.75+.25;o=vec4(tint*d,1.);}`;
const LVS=`#version 300 es
layout(location=0) in vec3 p;uniform mat4 mvp;
void main(){gl_Position=mvp*vec4(p,1.);}`;
const LFS=`#version 300 es
precision highp float;out vec4 o;void main(){o=vec4(1.,.55,.1,1.);}`;
const PVS=`#version 300 es
layout(location=0) in vec3 p;layout(location=1) in vec3 c;
uniform mat4 mvp;out vec3 vc;
void main(){vc=c;gl_Position=mvp*vec4(p,1.);}`;
const PFS=`#version 300 es
precision highp float;in vec3 vc;out vec4 o;void main(){o=vec4(vc,.85);}`;
function prog(vs,fs){const c=(t,s)=>{const h=gl.createShader(t);
 gl.shaderSource(h,s);gl.compileShader(h);
 if(!gl.getShaderParameter(h,gl.COMPILE_STATUS))
  throw gl.getShaderInfoLog(h);return h};
 const p=gl.createProgram();gl.attachShader(p,c(gl.VERTEX_SHADER,vs));
 gl.attachShader(p,c(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);return p}
const P=prog(VS,FS),LP=prog(LVS,LFS),PP=prog(PVS,PFS);
const uMVP=gl.getUniformLocation(P,"mvp"),uMV=gl.getUniformLocation(P,"mv"),
      uT=gl.getUniformLocation(P,"tint"),uL=gl.getUniformLocation(LP,"mvp"),
      uP=gl.getUniformLocation(PP,"mvp");
// mat helpers (column major)
function mul(a,b){const r=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];r[i*4+j]=s}return r}
function persp(f,asp,n,fr){const t=1/Math.tan(f/2);
 return new Float32Array([t/asp,0,0,0, 0,t,0,0,
  0,0,(fr+n)/(n-fr),-1, 0,0,2*fr*n/(n-fr),0])}
function lookAt(e,c,up){const z=norm3(sub(e,c)),x=norm3(cross(up,z)),
 y=cross(z,x);return new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0,
 x[2],y[2],z[2],0, -dot(x,e),-dot(y,e),-dot(z,e),1])}
const sub=(a,b)=>[a[0]-b[0],a[1]-b[1],a[2]-b[2]],
 dot=(a,b)=>a[0]*b[0]+a[1]*b[1]+a[2]*b[2],
 cross=(a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]],
 norm3=a=>{const l=Math.hypot(...a)||1;return[a[0]/l,a[1]/l,a[2]/l]};
// orbit camera + runtime-mutable controls (mirrors the reference's GUI
// toggles; state lives on the server so the runtime and every client agree)
let yaw=.7,pitch=.5,dist=30,target=[0,0,0],drag=null;
let ctl={pause:false,draw_mesh:true,draw_traj:true,follow:true};
async function setCtl(k,v){ctl[k]=v;
 try{ctl=await(await fetch("/controls",{method:"POST",
  body:JSON.stringify({[k]:v})})).json()}catch(e){}}
cv.addEventListener("mousedown",e=>drag=[e.clientX,e.clientY,e.button]);
addEventListener("mouseup",()=>drag=null);
addEventListener("mousemove",e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]===0){yaw-=dx*.005;pitch=Math.min(1.5,Math.max(-1.5,pitch+dy*.005))}
 else{const s=dist*.002,cy=Math.cos(yaw),sy=Math.sin(yaw);setCtl("follow",false);
  target[0]-=(-sy*dx-cy*dy)*s;target[1]-=(cy*dx-sy*dy)*s}
 drag=[e.clientX,e.clientY,drag[2]]});
cv.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*.001);e.preventDefault()});
cv.addEventListener("contextmenu",e=>e.preventDefault());
addEventListener("keydown",e=>{
 if(e.key==="f")setCtl("follow",!ctl.follow);
 else if(e.key===" "){setCtl("pause",!ctl.pause);e.preventDefault()}
 else if(e.key==="m")setCtl("draw_mesh",!ctl.draw_mesh);
 else if(e.key==="p")setCtl("draw_planes",!ctl.draw_planes);
 else if(e.key==="t")setCtl("draw_traj",!ctl.draw_traj)});
// region buffers
const regions=new Map();let seq=0,nTri=0,traj=[],trajBuf=gl.createBuffer(),
 trajN=0,fetching=false,planeBuf=gl.createBuffer(),planeN=0,nPlanes=0;
// plane-map overlay (pubPlaneMap analogue): each (center,normal,half,eig)
// row becomes a quad in the normal's tangent plane, colored green→red by
// min-eigenvalue (flat = green)
function buildPlanes(ab){const dv=new DataView(ab),m=dv.getInt32(0,true);
 nPlanes=m;const src=new Float32Array(ab,4,m*8);
 const out=new Float32Array(m*6*6);let o=0;
 for(let i=0;i<m;i++){const b=i*8,c=[src[b],src[b+1],src[b+2]],
  n=[src[b+3],src[b+4],src[b+5]],h=src[b+6],eig=src[b+7];
  const a=Math.abs(n[0])<.9?[1,0,0]:[0,1,0];
  const u=norm3(cross(n,a)),v=cross(n,u);
  const q=Math.min(1,eig/.05),col=[.2+.7*q,.8-.6*q,.25];
  const vx=[[-h,-h],[h,-h],[h,h],[-h,-h],[h,h],[-h,h]];
  for(const[s,t]of vx){out[o++]=c[0]+u[0]*s+v[0]*t;
   out[o++]=c[1]+u[1]*s+v[1]*t;out[o++]=c[2]+u[2]*s+v[2]*t;
   out[o++]=col[0];out[o++]=col[1];out[o++]=col[2]}}
 gl.bindBuffer(gl.ARRAY_BUFFER,planeBuf);
 gl.bufferData(gl.ARRAY_BUFFER,out,gl.DYNAMIC_DRAW);planeN=m*6}
async function poll(){if(fetching)return;fetching=true;
 try{ctl=await(await fetch("/controls")).json();
  const st=await(await fetch("/state?since="+seq)).json();
  traj=st.traj||[];
  if(traj.length){const f=new Float32Array(traj.length*3);
   for(let i=0;i<traj.length;i++){f[3*i]=traj[i][1];f[3*i+1]=traj[i][2];
    f[3*i+2]=traj[i][3]}
   gl.bindBuffer(gl.ARRAY_BUFFER,trajBuf);
   gl.bufferData(gl.ARRAY_BUFFER,f,gl.DYNAMIC_DRAW);trajN=traj.length;
   if(ctl.follow){const p=traj[traj.length-1];target=[p[1],p[2],p[3]]}}
  for(const rid of st.changed||[]){
   const ab=await(await fetch("/region/"+rid.join(","))).arrayBuffer();
   const dv=new DataView(ab),n=dv.getInt32(16,true);
   const data=new Float32Array(ab,20,n*9);
   let r=regions.get(rid.join(","));
   if(!r){r={buf:gl.createBuffer(),n:0};regions.set(rid.join(","),r)}
   gl.bindBuffer(gl.ARRAY_BUFFER,r.buf);
   gl.bufferData(gl.ARRAY_BUFFER,data,gl.DYNAMIC_DRAW);r.n=n*3}
  if(ctl.draw_planes){
   try{buildPlanes(await(await fetch("/planes")).arrayBuffer())}catch(e){}}
  seq=st.seq;nTri=st.n_triangles;
  hud.textContent=`immesh_tpu live — seq ${seq} · `+
   `${st.n_regions} regions · ${nTri} triangles`+
   (ctl.draw_planes?` · ${nPlanes} planes`:"")+
   (ctl.pause?" · PAUSED":"")+` · [drag] orbit · [right-drag] pan · `+
   `[wheel] zoom · [space] pause · [m] mesh ${ctl.draw_mesh?"on":"off"} · `+
   `[p] planes ${ctl.draw_planes?"on":"off"} · `+
   `[t] traj ${ctl.draw_traj?"on":"off"} · [f] follow ${ctl.follow?"on":"off"}`;
 }catch(e){hud.textContent="immesh_tpu — poll error: "+e}
 fetching=false}
setInterval(poll,400);poll();
function frame(){
 const w=innerWidth*devicePixelRatio,h=innerHeight*devicePixelRatio;
 if(cv.width!==w||cv.height!==h){cv.width=w;cv.height=h}
 gl.viewport(0,0,w,h);gl.clearColor(.063,.063,.078,1);
 gl.enable(gl.DEPTH_TEST);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const cp=Math.cos(pitch),eye=[target[0]+dist*cp*Math.cos(yaw),
  target[1]+dist*cp*Math.sin(yaw),target[2]+dist*Math.sin(pitch)];
 const mv=lookAt(eye,target,[0,0,1]),
  mvp=mul(persp(.9,w/h,.05,3000),mv);
 gl.useProgram(P);gl.uniformMatrix4fv(uMVP,false,mvp);
 gl.uniformMatrix4fv(uMV,false,mv);gl.uniform3f(uT,.55,.75,.95);
 gl.enableVertexAttribArray(0);
 if(ctl.draw_mesh)for(const r of regions.values()){if(!r.n)continue;
  gl.bindBuffer(gl.ARRAY_BUFFER,r.buf);
  gl.vertexAttribPointer(0,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.TRIANGLES,0,r.n)}
 if(ctl.draw_planes&&planeN>0){gl.useProgram(PP);
  gl.uniformMatrix4fv(uP,false,mvp);
  gl.bindBuffer(gl.ARRAY_BUFFER,planeBuf);
  gl.enableVertexAttribArray(1);
  gl.vertexAttribPointer(0,3,gl.FLOAT,false,24,0);
  gl.vertexAttribPointer(1,3,gl.FLOAT,false,24,12);
  gl.drawArrays(gl.TRIANGLES,0,planeN);
  gl.disableVertexAttribArray(1)}
 if(ctl.draw_traj&&trajN>1){gl.useProgram(LP);gl.uniformMatrix4fv(uL,false,mvp);
  gl.bindBuffer(gl.ARRAY_BUFFER,trajBuf);
  gl.vertexAttribPointer(0,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.LINE_STRIP,0,trajN)}
 requestAnimationFrame(frame)}
frame();
</script>
"""
