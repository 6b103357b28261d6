"""Interactive browser viewer: the port's windowing/GUI layer.

Port of nerf_glasses_tpu/apps/viewer_app.py. The reference renders into a
GLFW window with ImGui control panels (nerf_mesh_renderer.cu:378-452
window/GL init, :499-541 frame loop, :601-893 gui() panels, :896-916
mouse-orbit input handling). A GPU server has no display to swap to, so
the equivalent is a small zero-dependency HTTP server that streams
rendered frames to a browser canvas and maps the ImGui panel actions
onto the same `NerfMeshRenderer` methods the reference GUI calls:

  panel action (reference)                endpoint here
  ------------------------------------    -------------------------
  mouse drag / wheel (handleInput)        POST /api/orbit
  load/clear NeRF & mesh (:630-660)       POST /api/load_nerf,
                                          /api/load_mesh, /api/clear
  density-grid dump/load (:662-680)       POST /api/density
  per-object translate/rotate/scale       POST /api/transform
  light position (:760-770)               POST /api/light
  collide button (:773-780)               POST /api/collide
  camera trajectory recorder (:795-827)   POST /api/record_trajectory
  remove floaties (:782-790)              POST /api/remove_floaties
  FPS / VRAM stats panel (:829-874)       GET  /api/stats
  (the fast paths, not in the reference)  POST /api/bake, /api/toggle

Frames render in the HTTP handler's threads, one at a time under a lock.
The renderer's entry points run under torch.no_grad(), which is per
thread, so a frame of a network that trains builds no graph. On a CUDA
device the first frame after a mesh is loaded compiles the ray-cast
kernels (seconds) while it holds the lock; main() renders that frame
before it serves and prints the time.

Run: `python -m nerf_glasses_tpu_torch.apps.viewer_app --snapshot
s.msgpack [--mesh glasses.gltf] [--port 8000]`, then open
http://localhost:8000. The renderer lives on DEVICE.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

DEVICE = "cuda"

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>nerf-glasses-tpu viewer (PyTorch port)</title>
<style>
 body { margin:0; background:#16181d; color:#d7dae0; font:13px system-ui;
        display:flex; height:100vh; }
 #view { flex:1; display:flex; align-items:center; justify-content:center; }
 #frame { max-width:100%; max-height:100%; cursor:grab; }
 #panel { width:300px; padding:12px; background:#1e2128; overflow-y:auto; }
 h3 { margin:14px 0 6px; font-size:12px; text-transform:uppercase;
      color:#8b93a3; letter-spacing:.05em; }
 input, button { width:100%; box-sizing:border-box; margin:2px 0;
      background:#2a2e37; color:#d7dae0; border:1px solid #3a3f4b;
      border-radius:4px; padding:5px 8px; font:inherit; }
 button { cursor:pointer; } button:hover { background:#343947; }
 .row { display:flex; gap:4px; } .row input { flex:1; }
 #stats { white-space:pre; font:11px ui-monospace,monospace; color:#9aa3b2; }
 label { display:flex; gap:6px; align-items:center; margin:4px 0; }
 label input { width:auto; margin:0; }
</style></head><body>
<div id="view"><img id="frame" draggable="false"></div>
<div id="panel">
 <h3>Stats</h3><div id="stats">connecting…</div>
 <h3>NeRF</h3>
 <input id="nerfpath" placeholder="snapshot .msgpack path">
 <div class="row"><button onclick="loadNerf()">Load NeRF</button>
 <button onclick="api('clear',{what:'nerfs'})">Clear</button></div>
 <button onclick="api('remove_floaties',{})">Remove floaties</button>
 <div class="row"><input id="densfile" placeholder="density grid file">
 <button onclick="api('density',{op:'dump',filename:val('densfile')})">Dump</button>
 <button onclick="api('density',{op:'load',filename:val('densfile')})">Load</button></div>
 <label><input type="checkbox" id="flash"
   onchange="api('toggle',{name:'flash',value:this.checked})">
   flash fast path (bakes on first use)</label>
 <label><input type="checkbox"
   onchange="api('toggle',{name:'visualize_depth',value:this.checked})">
   depth overlay</label>
 <h3>Mesh</h3>
 <input id="meshpath" placeholder="mesh .gltf/.glb path">
 <div class="row"><button onclick="loadMesh()">Load mesh</button>
 <button onclick="api('clear',{what:'meshes'})">Clear</button></div>
 <h3>Transform (mesh 0)</h3>
 <div class="row"><input id="tx" value="0"><input id="ty" value="0">
 <input id="tz" value="0"></div>
 <div class="row"><input id="sc" value="1" title="uniform scale">
 <input id="ry" value="0" title="yaw deg"></div>
 <button onclick="applyTransform()">Apply translate / scale / yaw</button>
 <button onclick="api('collide',{direction:[0,-1,0],mesh:0})">Collide (drop)</button>
 <h3>Light</h3>
 <div class="row"><input id="lx" value="1"><input id="ly" value="1">
 <input id="lz" value="1"></div>
 <button onclick="api('light',{pos:[+val('lx'),+val('ly'),+val('lz')]})">
 Set light</button>
 <h3>Trajectory</h3>
 <button onclick="api('record_trajectory',{})">Record orbit trajectory</button>
</div>
<script>
const img = document.getElementById('frame');
const val = id => document.getElementById(id).value;
async function api(name, body) {
  const r = await fetch('/api/' + name, {method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify(body || {})});
  if (!r.ok) alert(name + ': ' + await r.text());
  return r.ok ? r.json() : null;
}
function loadNerf() { api('load_nerf', {path:val('nerfpath')}); }
function loadMesh() { api('load_mesh', {path:val('meshpath')}); }
function applyTransform() {
  api('transform', {mesh:0, t:[+val('tx'),+val('ty'),+val('tz')],
    s:+val('sc'), yaw_deg:+val('ry')});
}
// frame pump: request the next frame as soon as the last one lands
function pump() {
  const next = new Image();
  next.onload = () => { img.src = next.src; setTimeout(pump, 0); };
  next.onerror = () => setTimeout(pump, 500);
  next.src = '/frame.jpg?ts=' + Date.now();
}
pump();
// mouse: drag = orbit, shift-drag = slow orbit, wheel = zoom
let drag = null;
img.onmousedown = e => { drag = [e.clientX, e.clientY]; };
window.onmouseup = () => { drag = null; };
window.onmousemove = e => {
  if (!drag) return;
  const k = e.shiftKey ? 0.001 : 0.005;
  const [dx, dy] = [e.clientX - drag[0], e.clientY - drag[1]];
  drag = [e.clientX, e.clientY];
  if (dx || dy) api('orbit', {da: dx * k, dp: -dy * k, dz: 0});
};
img.onwheel = e => { e.preventDefault();
  api('orbit', {da:0, dp:0, dz: e.deltaY * -0.002}); };
setInterval(async () => {
  const s = await (await fetch('/api/stats')).json();
  document.getElementById('stats').textContent =
    Object.entries(s).map(([k, v]) => k.padEnd(22) + v).join('\\n');
}, 1000);
</script></body></html>"""


class ViewerState:
    """Shared renderer + lock: one device pipeline, many HTTP threads
    (the reference's single CUDA stream)."""

    def __init__(self, renderer):
        self.renderer = renderer
        self.lock = threading.Lock()
        self.jpeg_quality = 85

    def frame_jpeg(self) -> bytes:
        from PIL import Image
        with self.lock:
            self.renderer.frame()
            img = self.renderer.display_image()[..., :3]
        u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(u8).save(buf, "JPEG", quality=self.jpeg_quality)
        return buf.getvalue()

    # ---- panel actions (each maps to one reference gui() control) ----

    def api(self, name: str, req: dict) -> dict:
        r = self.renderer
        with self.lock:
            if name == "orbit":
                r.orbit(float(req.get("da", 0.0)), float(req.get("dp", 0.0)),
                        float(req.get("dz", 0.0)))
            elif name == "load_nerf":
                r.load_nerf(req["path"])
            elif name == "load_mesh":
                kw = {}
                for k in ("t", "s", "r"):
                    if k in req:
                        kw[k] = req[k]
                if r.load_mesh(req["path"], **kw) is None:
                    raise ValueError(f"failed to load {req['path']}")
            elif name == "clear":
                (r.clear_nerfs if req.get("what") == "nerfs"
                 else r.clear_meshes)()
            elif name == "transform":
                node = r._meshes[int(req.get("mesh", 0))].nodes[0]
                if "t" in req:
                    node.translation = np.asarray(req["t"], np.float32)
                if "s" in req:
                    s = req["s"]
                    node.scale = np.asarray(
                        [s] * 3 if np.isscalar(s) else s, np.float32)
                if "yaw_deg" in req:
                    h = np.deg2rad(float(req["yaw_deg"])) / 2.0
                    node.rotation = np.array(
                        [np.cos(h), 0.0, np.sin(h), 0.0], np.float32)
                if "r" in req:
                    node.rotation = np.asarray(req["r"], np.float32)
                r._rebuild_mesh_arrays()
            elif name == "light":
                r.light_pos = np.asarray(req["pos"], np.float32)
            elif name == "remove_floaties":
                r.remove_floaties()
            elif name == "density":
                if req["op"] == "dump":
                    r.dump_density_grid_file(req["filename"])
                else:
                    r.load_density_grid_file(req["filename"])
            elif name == "collide":
                node = r._meshes[int(req.get("mesh", 0))].nodes[0]
                r.collide(np.asarray(req.get("direction", [0, -1, 0]),
                                     np.float32), node)
            elif name == "record_trajectory":
                kw = {k: req[k] for k in ("distance", "height",
                                          "start_angle", "end_angle",
                                          "num_images", "out_dir")
                      if k in req}
                if "num_images" in kw:
                    kw["num_images"] = int(kw["num_images"])
                r.record_trajectory(**kw)
            elif name == "bake":
                for nerf in r._nerfs:
                    nerf.bake(int(req.get("resolution", 256)))
            elif name == "toggle":
                v = bool(req.get("value", True))
                attr = req["name"]
                if attr == "flash":
                    for nerf in r._nerfs:
                        if v and getattr(nerf, "_baked_sigma", None) is None:
                            nerf.bake(int(req.get("resolution", 256)))
                        nerf.flash = v
                elif attr == "visualize_depth":
                    r.visualize_depth = v
                elif attr == "profile":
                    r.profile = v
                else:
                    raise ValueError(f"unknown toggle {attr!r}")
            else:
                raise ValueError(f"unknown api endpoint {name!r}")
        return {"ok": True}

    def stats(self) -> dict:
        with self.lock:
            s = dict(self.renderer.stats())
        return {k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in s.items()}


class _Handler(BaseHTTPRequestHandler):
    state: ViewerState = None  # set by serve()

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # quiet
        pass

    def do_GET(self):
        path = self.path.split("?")[0]
        try:
            if path == "/":
                self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            elif path == "/frame.jpg":
                self._send(200, self.state.frame_jpeg(), "image/jpeg")
            elif path == "/api/stats":
                self._send(200, json.dumps(self.state.stats()).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")
        except BrokenPipeError:
            pass
        except Exception as e:  # surface errors to the panel
            self._send(500, str(e).encode(), "text/plain")

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length") or 0)
            req = json.loads(self.rfile.read(n) or b"{}")
            out = self.state.api(self.path.removeprefix("/api/"), req)
            self._send(200, json.dumps(out).encode(), "application/json")
        except BrokenPipeError:
            pass
        except Exception as e:
            self._send(500, str(e).encode(), "text/plain")


def make_server(renderer, host: str = "127.0.0.1", port: int = 8000
                ) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral) and return the server; caller runs
    serve_forever (tests run it on a thread)."""
    handler = type("Handler", (_Handler,), {"state": ViewerState(renderer)})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--snapshot", help="NGP .msgpack snapshot to load")
    parser.add_argument("--mesh", help="glTF/GLB mesh to load")
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    args = parser.parse_args(argv)

    import pynmr_torch
    renderer = pynmr_torch.NerfMeshRenderer(args.width, args.height,
                                            device=DEVICE)
    if args.snapshot:
        renderer.load_nerf(args.snapshot)
    if args.mesh:
        renderer.load_mesh(args.mesh)
    if args.snapshot:
        t0 = time.perf_counter()
        renderer.frame()
        renderer.display_image()
        print(f"viewer: first frame {time.perf_counter() - t0:.2f} s"
              + (" (builds the mesh ray-cast kernels on a CUDA device)"
                 if args.mesh else "; the first frame after a mesh is "
                 "loaded builds the ray-cast kernels on a CUDA device"),
              flush=True)

    server = make_server(renderer, args.host, args.port)
    print(f"viewer: http://{args.host}:{server.server_address[1]}/",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
