"""Interactive web viewer, as in tpugs/viewer/server.py: an HTML page with
orbit controls; every interaction POSTs a camera state to /render and gets
a freshly rendered JPEG back.

- orbit / pan / zoom camera;
- RGB / depth (1 - final_T, turbo) / contributor-heatmap modes;
- half-resolution frames while dragging (scale 2), which take the
  frame-coherent cached path (OfflineRenderer.render_interactive), and a
  full-resolution exact frame on release; depth and heatmap frames are
  always exact;
- an FPS overlay, an SH-degree slider and a vertical-FOV slider.

Renders run on the renderer's device, named explicitly in every handler
thread, one at a time under a lock.
"""
from __future__ import annotations

import contextlib
import io
import json
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
from PIL import Image

from tpugs_torch.viewer.camera import OrbitCamera
from tpugs_torch.viewer.offline import OfflineRenderer

_PAGE = """<!DOCTYPE html>
<html><head><title>tpugs viewer</title><style>
 body { margin:0; background:#111; color:#ddd; font-family:monospace; overflow:hidden }
 #hud { position:fixed; top:8px; left:8px; background:#0008; padding:6px 10px; border-radius:4px }
 #panel { position:fixed; top:8px; right:8px; background:#0008; padding:6px 10px;
          border-radius:4px; display:flex; flex-direction:column; gap:4px }
 #panel label { display:flex; align-items:center; gap:6px; font-size:12px }
 img { display:block; width:100vw; height:100vh; object-fit:contain; cursor:grab }
</style></head><body>
<div id="hud">tpugs viewer — drag: orbit | shift-drag: pan | wheel: zoom | m: mode</div>
<div id="panel">
 <label>SH <input id="sh" type="range" min="0" max="3" step="1" value="3">
   <span id="shv">3</span></label>
 <label>FOV <input id="fov" type="range" min="20" max="120" step="1" value="60">
   <span id="fovv">60°</span></label>
</div>
<img id="view" draggable="false">
<script>
let az=0, el=0.3, radius=null, tx=0, ty=0, tz=0, mode=0, seq=0, inflight=false, dragging=false;
let shDeg=3, fovDeg=60;
const modes=["rgb","depth","heatmap"];
const img=document.getElementById("view"), hud=document.getElementById("hud");
const shIn=document.getElementById("sh"), fovIn=document.getElementById("fov");
let lastT=performance.now();
async function refresh(low) {
  if (inflight) return; inflight = true;
  const mySeq = ++seq;
  const r = await fetch("/render", {method:"POST", body: JSON.stringify({
    azimuth:az, elevation:el, radius:radius, pan:[tx,ty,tz], mode:modes[mode],
    sh:shDeg, fov:fovDeg, scale: low?2:1})});
  const blob = await r.blob();
  if (mySeq === seq) img.src = URL.createObjectURL(blob);
  const now=performance.now();
  hud.textContent = `tpugs — ${modes[mode]} — ${(1000/(now-lastT)).toFixed(1)} fps`;
  lastT=now; inflight = false;
  if (!dragging && low) refresh(false);
}
let px=0, py=0;
img.onmousedown = e => { dragging=true; px=e.clientX; py=e.clientY; };
window.onmouseup = () => { if (dragging) { dragging=false; refresh(false);} };
window.onmousemove = e => {
  if (!dragging) return;
  const dx=(e.clientX-px)/300, dy=(e.clientY-py)/300; px=e.clientX; py=e.clientY;
  if (e.shiftKey) { tx += -dx; ty += dy; } else { az += dx; el = Math.max(-1.4, Math.min(1.4, el+dy)); }
  refresh(true);
};
window.onwheel = e => { radius = (radius||5) * (e.deltaY>0?1.1:0.9); refresh(true); };
window.onkeydown = e => { if (e.key=="m") { mode=(mode+1)%3; refresh(false);} };
shIn.oninput = () => { shDeg=+shIn.value; document.getElementById("shv").textContent=shIn.value; refresh(false); };
fovIn.oninput = () => { fovDeg=+fovIn.value; document.getElementById("fovv").textContent=fovIn.value+"°"; refresh(true); };
fetch("/info").then(r=>r.json()).then(j=>{
  radius=j.radius; shDeg=j.max_sh_degree; shIn.max=j.max_sh_degree;
  shIn.value=shDeg; document.getElementById("shv").textContent=shDeg;
  refresh(false);
});
</script></body></html>"""


class ViewerServer:
    def __init__(self, params: dict, width: int = 1280, height: int = 720,
                 background=(0.0, 0.0, 0.0), sh_degree: int = -1,
                 tile: int = 32, pair_capacity: int = 1 << 21,
                 max_hits: int = 2048, on_overflow: str = "grow",
                 device: str | torch.device = "cuda"):
        self.renderer = OfflineRenderer(
            params, sh_degree=sh_degree, tile=tile,
            pair_capacity=pair_capacity, max_hits=max_hits,
            on_overflow=on_overflow, device=device,
        )
        self.width = width
        self.height = height
        self.background = background
        means = np.asarray(params["means"])
        self.base_cam = OrbitCamera.from_points(means)
        self.num_gaussians = means.shape[0]
        # The handler threads share one renderer, whose anchor cache and
        # capacities a render changes: one render at a time.
        self._render_lock = threading.Lock()

    def _on_device(self):
        """The renderer's card as the thread's current device (a handler
        thread starts on device 0), or nothing on the CPU."""
        dev = self.renderer.device
        if dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def render_jpeg(self, req: dict) -> bytes:
        cam = OrbitCamera(
            target=self.base_cam.target + np.asarray(req.get("pan", [0, 0, 0])),
            radius=float(req.get("radius") or self.base_cam.radius),
            azimuth=float(req.get("azimuth", 0.0)),
            elevation=float(req.get("elevation", 0.3)),
            fov_y_deg=float(
                np.clip(req.get("fov") or self.base_cam.fov_y_deg, 5.0, 170.0)
            ),
        )
        scale = int(req.get("scale", 1))  # 2 = half resolution while dragging
        w, h = self.width // scale, self.height // scale
        # Snap to the renderer's tile grid.
        t = self.renderer.tile
        w -= w % t or 0
        h -= h % t or 0
        info = cam.build_camera(max(w, t), max(h, t))
        sh_deg = int(req.get("sh", -1) if req.get("sh") is not None else -1)
        mode = req.get("mode", "rgb")
        # Drag frames take the cached path; release frames (scale 1) and
        # the depth and heatmap modes stay exact.
        interactive = scale != 1 and mode == "rgb"
        with self._render_lock, self._on_device():
            if interactive:
                color, _ = self.renderer.render_interactive(
                    info.height, info.width, info.world_to_camera(),
                    info.intrinsics_array(), self.background,
                    sh_degree=sh_deg,
                )
                img = np.clip(color.cpu().numpy(), 0.0, 1.0)
            else:
                img = self.renderer.render_camera(info, mode,
                                                  self.background,
                                                  sh_degree=sh_deg)
        buf = io.BytesIO()
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            buf, "JPEG", quality=90
        )
        return buf.getvalue()

    def make_server(self, host: str = "127.0.0.1",
                    port: int = 8000) -> ThreadingHTTPServer:
        """The HTTP server, bound and not yet serving (port 0 takes a free
        one: server.server_address names it)."""
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path == "/info":
                    self._send(200, "application/json", json.dumps({
                        "radius": viewer.base_cam.radius,
                        "num_gaussians": viewer.num_gaussians,
                        "max_sh_degree": viewer.renderer.max_sh_degree,
                    }).encode())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path != "/render":
                    self._send(404, "text/plain", b"not found")
                    return
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                try:
                    jpg = viewer.render_jpeg(req)
                except Exception as e:  # the server keeps serving
                    traceback.print_exc(file=sys.stderr)
                    self._send(500, "text/plain", str(e).encode())
                    return
                self._send(200, "image/jpeg", jpg)

        return ThreadingHTTPServer((host, port), Handler)

    def serve(self, host: str = "127.0.0.1", port: int = 8000):
        server = self.make_server(host, port)
        print(f"tpugs_torch viewer on http://{host}:{server.server_address[1]}"
              f"  ({self.num_gaussians} gaussians, {self.renderer.device})")
        try:
            server.serve_forever()
        finally:
            server.server_close()
