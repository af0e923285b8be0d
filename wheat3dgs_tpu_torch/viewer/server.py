"""Interactive web viewer (reference: wheat3dgsviewer/, a viser+nerfview
fork).

Counterpart of wheat3dgs_tpu/viewer/server.py: a self-contained stdlib
http.server viewer with the same capabilities, rendering on the port's
device:

- orbit/zoom/pan camera driven from the browser (JS sends camera state,
  server renders JPEG frames through render_fwd);
- per-head instance overlay with an id whitelist (reference
  wheat3dgsviewer/gaussian_renderer/render_helper.py:68-108);
- COLMAP train/test camera list with click-to-teleport (reference
  wheatgs_rendering.py:133-234);
- scale-filtered rendering (viewer fork drops splats with scale > 0.1,
  wheat3dgsviewer/gaussian_renderer/__init__.py:159-167).
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .. import resolve_device
from ..ops.binning import pick_entry_budget
from ..render.pipeline import RasterConfig, render_fwd
from ..seg.eval import eval_obj_labels
from ..utils import graphics, image_ops

_PAGE = """<!DOCTYPE html><html><head><title>wheat3dgs_tpu_torch viewer</title>
<style>body{margin:0;background:#111;color:#ddd;font-family:sans-serif}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:8px;border-radius:6px}
img{width:100vw;height:100vh;object-fit:contain;display:block}
select,input{margin:2px}</style></head><body>
<div id="hud">
 <div>drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan</div>
 <select id="cams"><option value="">teleport to camera...</option></select>
 <label><input type="checkbox" id="overlay"> head overlay</label>
 <input id="heads" placeholder="head ids e.g. 1,2" size="12">
</div>
<img id="view">
<script>
let az=0.8, el=0.7, dist=4.0, cx=0, cy=0, cz=0, busy=false, dirty=true;
const img=document.getElementById('view');
fetch('/info').then(r=>r.json()).then(d=>{
  cx=d.center[0]; cy=d.center[1]; cz=d.center[2]; dist=d.radius*2;
  const sel=document.getElementById('cams');
  d.cameras.forEach((c,i)=>{const o=document.createElement('option');
    o.value=i; o.text=c; sel.appendChild(o);});
  dirty=true;});
document.getElementById('cams').onchange=e=>{
  if(e.target.value==='')return;
  fetch('/teleport?i='+e.target.value).then(r=>r.json()).then(d=>{
    az=d.az; el=d.el; dist=d.dist; cx=d.center[0]; cy=d.center[1];
    cz=d.center[2]; dirty=true;});};
document.getElementById('overlay').onchange=()=>dirty=true;
document.getElementById('heads').onchange=()=>dirty=true;
let drag=false,px=0,py=0,pan=false;
img.onmousedown=e=>{drag=true;pan=e.shiftKey;px=e.clientX;py=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-px, dy=e.clientY-py; px=e.clientX; py=e.clientY;
  if(pan){cx-=dx*dist*0.001*Math.sin(az); cy+=dx*dist*0.001*Math.cos(az);
          cz+=dy*dist*0.001;}
  else{az-=dx*0.01; el=Math.min(1.5,Math.max(-1.5,el+dy*0.01));}
  dirty=true;};
img.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001); dirty=true; e.preventDefault();};
function tick(){
  if(dirty&&!busy){busy=true; dirty=false;
    const ov=document.getElementById('overlay').checked?1:0;
    const hd=encodeURIComponent(document.getElementById('heads').value);
    img.src='/render?az='+az+'&el='+el+'&dist='+dist+'&cx='+cx+'&cy='+cy+
      '&cz='+cz+'&overlay='+ov+'&heads='+hd+'&t='+Date.now();
    img.onload=()=>busy=false; img.onerror=()=>busy=false;}
  requestAnimationFrame(tick);}
tick();
</script></body></html>"""

class ViewerState:
    def __init__(self, state, sh_degree: int, width: int = 960,
                 height: int = 720, fovx: float = 0.9,
                 obj_labels: Optional[np.ndarray] = None,
                 camera_names=(), camera_poses=None,
                 scale_filter: float = 0.1,
                 config: RasterConfig = RasterConfig(), device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if state.device != self.device:
            raise ValueError(f"the state lives on {state.device}, the viewer "
                             f"renders on {self.device}")
        # Viewer fork drops splats with any scale > scale_filter
        # (wheat3dgsviewer/gaussian_renderer/__init__.py:159-167).
        if scale_filter is not None:
            keep = state.scales().max(dim=1).values <= scale_filter
            state = dataclasses.replace(state, alive=state.alive & keep)
        self.state = state
        self.sh_degree = sh_degree
        self.width, self.height = width, height
        self.fovx = fovx
        self.fovy = graphics.focal2fov(graphics.fov2focal(fovx, width),
                                       height)
        self.obj_labels = obj_labels          # (L+1, cap) bool or None
        if obj_labels is not None:
            self._labels = torch.as_tensor(np.asarray(obj_labels, bool),
                                           device=self.device)
            self._nonempty = np.asarray(obj_labels).any(axis=1).tolist()
        self.camera_names = list(camera_names)
        self.camera_poses = camera_poses or []  # list of (eye, target)
        self.config = config
        self.reprobes = 0                     # budget raises after overflow
        pts = state.params.means[state.alive].cpu().numpy()
        self.center = pts.mean(axis=0) if len(pts) else np.zeros(3)
        self.radius = float(np.linalg.norm(
            pts - self.center, axis=1).max()) if len(pts) else 1.0
        self.lock = threading.Lock()

    def camera_from_orbit(self, az, el, dist, center):
        eye = center + dist * np.array([
            math.cos(az) * math.cos(el), math.sin(az) * math.cos(el),
            math.sin(el)])
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        world_down = np.array([0.0, 0.0, -1.0])
        right = np.cross(fwd, world_down)
        n = np.linalg.norm(right)
        right = right / (n if n > 1e-6 else 1.0)
        down = -np.cross(fwd, right)
        R = np.stack([right, down, fwd])
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = -R @ eye
        proj = graphics.projection_matrix(0.01, 100.0, self.fovx, self.fovy)
        return (w2c.astype(np.float32), (proj @ w2c).astype(np.float32),
                eye.astype(np.float32))

    def _cam(self, az, el, dist, center):
        w2c, fp, eye = self.camera_from_orbit(az, el, dist, center)
        dev = self.device
        return (torch.as_tensor(w2c, device=dev),
                torch.as_tensor(fp, device=dev),
                torch.as_tensor(eye, device=dev),
                math.tan(self.fovx / 2), math.tan(self.fovy / 2))

    def render_image(self, az, el, dist, center, overlay=False,
                     head_whitelist=None) -> np.ndarray:
        """The (3, H, W) float image in [0, 1] that render_frame encodes."""
        cam = self._cam(az, el, dist, center)
        with self.lock:
            out = render_fwd(self.state, *cam, self.width, self.height,
                             sh_degree=self.sh_degree, config=self.config)
            total = (int(out.entries_total) if self.config.backend
                     == "pallas" else 0)
            if total > self.config.entry_budget:
                # A novel view exceeded the probed entry budget (the render
                # cropped splats): raise the rung and re-render this frame.
                # Budgets only grow, so this settles after a few frames.
                self.config = dataclasses.replace(
                    self.config, entry_budget=pick_entry_budget(total))
                self.reprobes += 1
                out = render_fwd(self.state, *cam, self.width, self.height,
                                 sh_degree=self.sh_degree,
                                 config=self.config)
            img = np.clip(out.color.cpu().numpy(), 0, 1)
            if overlay and self.obj_labels is not None:
                labels, nonempty = self._labels, self._nonempty
                if head_whitelist:
                    keep = [i == 0 or i in head_whitelist
                            for i in range(labels.shape[0])]
                    labels = labels & torch.as_tensor(
                        keep, device=self.device)[:, None]
                    nonempty = [a and b for a, b in zip(nonempty, keep)]
                pred = eval_obj_labels(
                    self.state, labels, *cam, width=self.width,
                    height=self.height, config=self.config,
                    nonempty=nonempty).cpu().numpy()
                mask_rgb = image_ops.visualize_obj(pred).astype(
                    np.float32) / 255.0
                img = image_ops.overlay_image(img, mask_rgb)
        return img

    def render_frame(self, az, el, dist, center, overlay=False,
                     head_whitelist=None) -> bytes:
        """One view as JPEG bytes."""
        from PIL import Image

        img = self.render_image(az, el, dist, center, overlay,
                                head_whitelist)
        buf = io.BytesIO()
        Image.fromarray((img.transpose(1, 2, 0) * 255).astype(
            np.uint8)).save(buf, format="JPEG", quality=85)
        return buf.getvalue()


def make_handler(vs: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif url.path == "/info":
                self._send(200, json.dumps({
                    "center": vs.center.tolist(), "radius": vs.radius,
                    "cameras": vs.camera_names,
                    "n_heads": 0 if vs.obj_labels is None
                    else int(vs.obj_labels.shape[0] - 1)}).encode())
            elif url.path == "/teleport":
                i = int(q.get("i", 0))
                eye, target = vs.camera_poses[i]
                d = np.asarray(eye) - np.asarray(target)
                dist = float(np.linalg.norm(d))
                self._send(200, json.dumps({
                    "az": math.atan2(d[1], d[0]),
                    "el": math.asin(np.clip(d[2] / dist, -1, 1)),
                    "dist": dist,
                    "center": np.asarray(target).tolist()}).encode())
            elif url.path == "/render":
                heads = None
                if q.get("heads"):
                    heads = {int(x) for x in q["heads"].split(",")
                             if x.strip().isdigit()}
                jpeg = vs.render_frame(
                    float(q.get("az", 0.8)), float(q.get("el", 0.7)),
                    float(q.get("dist", 4.0)),
                    np.array([float(q.get("cx", 0)), float(q.get("cy", 0)),
                              float(q.get("cz", 0))]),
                    overlay=q.get("overlay") == "1", head_whitelist=heads)
                self._send(200, jpeg, "image/jpeg")
            else:
                self._send(404, b"{}")

    return Handler


def serve(vs: ViewerState, host: str = "0.0.0.0", port: int = 8080,
          blocking: bool = True):
    httpd = ThreadingHTTPServer((host, port), make_handler(vs))
    print(f"viewer on http://{host}:{port}")
    if blocking:
        httpd.serve_forever()
    else:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
    return httpd
