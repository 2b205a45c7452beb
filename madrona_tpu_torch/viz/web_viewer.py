"""Interactive web viewer: flycam and sim controls over HTTP, stdlib only.

Port of ``madrona_tpu/viz/web_viewer.py`` (the reference's GLFW/Vulkan
viewer, ``src/viz/viewer.cpp``: flycam, world switching, pause and
single step, keyboard agent control), served to a browser. The page
polls ``/frame.png`` (the batch raycaster's view from a free camera),
``/topdown.png`` and ``/state``, and posts key events:

- flycam: W/A/S/D move, Q/E down/up, arrow keys yaw/pitch
- Space pause/resume, N single-step, R reset the current world
- [ / ] switch world
- optional env-specific agent control through ``key_to_inputs``

A frame is ``render/raycast.py::camera_rays`` and the dense tracer
``_trace_rays`` (or ``render/blas.py::trace_scene_blas`` when ``blas``
is given) on the sim's device; the JAX viewer traces through the same
plain tracer. The server binds 127.0.0.1. Start it with
``WebViewer(...).serve()`` or see ``examples/torch_viewer_demo.py``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs

import numpy as np
import torch

from .viewer import png_bytes, render_topdown, to_numpy


def flycam_quat(yaw: float, pitch: float) -> np.ndarray:
    """Free-camera orientation quaternion (w,x,y,z): yaw around -z
    (screen-right positive), then pitch around +x."""
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    qz = np.array([cy, 0.0, 0.0, -sy])
    qx = np.array([cp, sp, 0.0, 0.0])
    w1, x1, y1, z1 = qz
    w2, x2, y2, z2 = qx
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def rgbd_panel(rgb, depth) -> np.ndarray:
    """One agent view as an [H, W or 2W, 3] float panel: RGB left, depth
    normalized per frame as grayscale right (the reference viewer's
    batch-renderer RGBD view)."""
    rgb = to_numpy(rgb).astype(np.float32)
    if depth is None:
        return rgb
    d = to_numpy(depth).astype(np.float32)
    d = d / max(float(np.max(d)), 1e-6)
    return np.concatenate([rgb, np.repeat(d[..., None], 3, axis=-1)], axis=1)


def frame_renderer(width: int, height: int, fov_deg: float, mesh,
                   render_obj, body_mask, device, blas=None,
                   materials=None) -> Callable:
    """``frame(pos [N, 3], rot [N, 4], scale [N, 3], cam_pos [3],
    cam_rot [4]) -> (rgb [height, width, 3], depth [height, width])``:
    one world's bodies seen from a free camera, traced on ``device`` by
    the dense tracer (or the mesh-BVH tier with ``blas``)."""
    from ..render.raycast import RenderConfig, _trace_rays, camera_rays

    dev = torch.device(device)
    cfg = RenderConfig(width=width, height=height, fov_deg=fov_deg)
    robj = torch.as_tensor(np.asarray(render_obj, np.int32), device=dev)
    n = robj.shape[0]
    bmask = torch.as_tensor(
        np.ones((n,), bool) if body_mask is None
        else np.asarray(body_mask, bool), device=dev)
    if blas is not None:
        from ..render.blas import trace_scene_blas

        blas = blas.to(dev)
        materials = None if materials is None else materials.to(dev)

        def trace(pos, rot, scale, o, d):
            return trace_scene_blas(cfg, blas, pos, rot, scale, robj, bmask,
                                    o, d, materials=materials)
    else:
        mesh = mesh.to(dev)

        def trace(pos, rot, scale, o, d):
            return _trace_rays(cfg, mesh, pos, rot, scale, robj, bmask, o, d)

    def frame(pos, rot, scale, cam_pos, cam_rot):
        f32 = dict(dtype=torch.float32, device=dev)
        o, d = camera_rays(cfg, torch.as_tensor(cam_pos, **f32),
                           torch.as_tensor(cam_rot, **f32))
        rgb, depth = trace(torch.as_tensor(pos, **f32),
                           torch.as_tensor(rot, **f32),
                           torch.as_tensor(scale, **f32),
                           o.reshape(-1, 3), d.reshape(-1, 3))
        return rgb.reshape(height, width, 3), depth.reshape(height, width)

    return frame


class Flycam:
    """The free camera both viewers share: position, yaw (radians around
    +z; 0 looks along +y) and pitch, moved by keys."""

    STEP_LIN = 0.8
    STEP_ANG = 0.12

    def __init__(self):
        self.cam_pos = np.array([0.0, -12.0, 6.0], np.float64)
        self.yaw = 0.0
        self.pitch = -0.3

    def cam_quat(self) -> np.ndarray:
        return flycam_quat(self.yaw, self.pitch)

    def move(self, k: str) -> bool:
        """Apply a flycam key; False if ``k`` is not one."""
        fwd = np.array([np.sin(self.yaw), np.cos(self.yaw), 0.0])
        right = np.array([np.cos(self.yaw), -np.sin(self.yaw), 0.0])
        lin, ang = self.STEP_LIN, self.STEP_ANG
        if k == "w":
            self.cam_pos += fwd * lin
        elif k == "s":
            self.cam_pos -= fwd * lin
        elif k == "a":
            self.cam_pos -= right * lin
        elif k == "d":
            self.cam_pos += right * lin
        elif k == "q":
            self.cam_pos[2] -= lin
        elif k == "e":
            self.cam_pos[2] += lin
        elif k == "ArrowLeft":
            self.yaw -= ang
        elif k == "ArrowRight":
            self.yaw += ang
        elif k == "ArrowUp":
            self.pitch = min(self.pitch + ang, 1.5)
        elif k == "ArrowDown":
            self.pitch = max(self.pitch - ang, -1.5)
        else:
            return False
        return True


def serve_routes(routes: Dict[str, Callable], port: int
                 ) -> ThreadingHTTPServer:
    """A threading HTTP server on 127.0.0.1:``port`` (0: any free port)
    answering GET ``path`` with ``routes[path](query) -> (body, content
    type)``; 404 for any other path, or where a route returns None."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            path, _, query = self.path.partition("?")
            route = routes.get(path)
            try:
                res = route(parse_qs(query)) if route else None
            except BrokenPipeError:
                return
            if res is None:
                self.send_error(404)
                return
            body, ctype = res
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


_PAGE = """<!doctype html>
<html><head><title>madrona_tpu viewer</title><style>
body { background: #111; color: #ddd; font-family: monospace; }
img { image-rendering: pixelated; border: 1px solid #444; }
#hud { margin: 8px 0; }
#agents img { height: 128px; margin-right: 4px; }
</style></head><body>
<div id="hud">loading…</div>
<img id="cam" width="640" height="480">
<img id="top" width="480" height="480">
<div id="agents"></div>
<div>W/A/S/D move · Q/E down/up · arrows look · Space pause · N step ·
R reset · [ ] world</div>
<script>
let numViews = 0;
async function refresh() {
  const t = Date.now();
  document.getElementById('cam').src = '/frame.png?t=' + t;
  document.getElementById('top').src = '/topdown.png?t=' + t;
  const s = await (await fetch('/state')).json();
  document.getElementById('hud').textContent =
    `world ${s.world}  step ${s.step}  ` +
    (s.paused ? 'PAUSED' : 'running') +
    `  cam ${s.cam.map(v => v.toFixed(1))}`;
  if (s.num_views !== numViews) {
    numViews = s.num_views;
    const row = document.getElementById('agents');
    row.innerHTML = '';
    for (let v = 0; v < numViews; v++) {
      const im = document.createElement('img');
      im.id = 'agent' + v;
      row.appendChild(im);
    }
  }
  for (let v = 0; v < numViews; v++)
    document.getElementById('agent' + v).src = `/agent.png?v=${v}&t=${t}`;
}
setInterval(refresh, 100);
document.addEventListener('keydown', e => {
  fetch('/key?k=' + encodeURIComponent(e.key));
  if ([' ', 'ArrowUp', 'ArrowDown'].includes(e.key)) e.preventDefault();
});
</script></body></html>"""


def _state_device(sim) -> torch.device:
    return sim.state.rng.device


class WebViewer(Flycam):
    """Serve an interactive view of a running sim.

    Parameters
    ----------
    sim: models.base.Sim (or anything with .state and .step_fn())
    mesh: render.MeshTables for the bodies' render objects
    render_obj: [N] int render object per body row
    body_arch: archetype holding Position/Rotation/Scale
    inputs_fn: () -> step inputs dict (default: zero int32 ``action``
        and ``reset`` slots shaped as the env declares, on the sim's
        device)
    key_to_inputs: optional (key, inputs) -> inputs hook for agent
        control (the viewer.cpp keyboard agent-control analogue)
    """

    def __init__(self, sim, mesh, render_obj, body_arch: str = "RigidBody",
                 width: int = 320, height: int = 240, fov_deg: float = 90.0,
                 inputs_fn: Optional[Callable[[], Dict]] = None,
                 key_to_inputs: Optional[Callable] = None,
                 world: int = 0, fps: float = 20.0,
                 body_mask=None,
                 rgb_key: str = "rgb", depth_key: str = "depth",
                 blas=None, materials=None):
        super().__init__()
        self.sim = sim
        self.world = world
        self.paused = False
        self.step_count = 0
        self.fps = fps
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.key_to_inputs = key_to_inputs
        self.body_arch = body_arch
        # step-output keys holding agent RGBD views ([W,V,H,Wd,3] /
        # [W,V,H,Wd]); populated by the env's render graph if any
        self.rgb_key = rgb_key
        self.depth_key = depth_key
        self.last_outputs: Dict = {}
        # the render tables as given (a frame traced elsewhere, on another
        # device, starts from these)
        self.mesh, self.render_obj, self.body_mask = (
            mesh, render_obj, body_mask)
        dev = _state_device(sim)

        self._step = sim.step_fn()
        if inputs_fn is None:
            env = getattr(sim, "env", None)
            num_worlds = self._num_worlds()
            act_shape = getattr(env, "action_shape", ()) if env else ()

            def inputs_fn():
                return {
                    "action": torch.zeros((num_worlds,) + tuple(act_shape),
                                          dtype=torch.int32, device=dev),
                    "reset": torch.zeros((num_worlds,), dtype=torch.int32,
                                         device=dev),
                }

        self.inputs_fn = inputs_fn
        self.inputs = inputs_fn()
        self._frame = frame_renderer(width, height, fov_deg, mesh,
                                     render_obj, body_mask, dev, blas=blas,
                                     materials=materials)

    # ------------------------------------------------------------ control

    def handle_key(self, k: str) -> None:
        with self._lock:
            if self.move(k):
                return
            if k == " ":
                self.paused = not self.paused
            elif k == "n":
                self._advance_locked()
            elif k == "r":
                self._reset_world_locked()
            elif k == "[":
                self.world = max(0, self.world - 1)
            elif k == "]":
                self.world = min(self._num_worlds() - 1, self.world + 1)
            elif self.key_to_inputs is not None:
                self.inputs = self.key_to_inputs(k, self.inputs)

    def _bodies(self):
        return self.sim.state.tables[self.body_arch].columns

    def _num_worlds(self) -> int:
        return int(self._bodies()["Position"].shape[0])

    def _advance_locked(self):
        state, outputs = self._step(self.sim.state, self.inputs)
        self.sim.state = state
        self.last_outputs = outputs or {}
        self.step_count += 1
        self.inputs = self.inputs_fn()   # one-shot inputs decay to zero

    def _reset_world_locked(self):
        inp = dict(self.inputs)
        if "reset" in inp:
            reset = torch.zeros_like(inp["reset"])
            reset[self.world] = 1
            inp["reset"] = reset
        state, outputs = self._step(self.sim.state, inp)
        self.sim.state = state
        self.last_outputs = outputs or {}
        self.step_count += 1

    def tick(self) -> None:
        """Advance one sim step if running (called by the loop thread)."""
        with self._lock:
            if not self.paused:
                self._advance_locked()

    # ------------------------------------------------------------- frames

    def _num_views(self) -> int:
        rgb = self.last_outputs.get(self.rgb_key)
        return 0 if rgb is None or rgb.dim() < 5 else int(rgb.shape[1])

    def frame(self):
        """The flycam's (rgb [H, W, 3], depth [H, W]) of the current
        world, on the sim's device."""
        with self._lock:
            cols, w = self._bodies(), self.world
            return self._frame(
                cols["Position"][w], cols["Rotation"][w], cols["Scale"][w],
                self.cam_pos, self.cam_quat())

    def frame_png(self) -> bytes:
        return png_bytes(self.frame()[0])

    def agent_png(self, view: int = 0) -> bytes:
        """One agent camera's RGBD observation from the last step's
        outputs (RGB | normalized depth side by side)."""
        with self._lock:
            nv = self._num_views()
            if nv == 0:
                return png_bytes(np.full((8, 8, 3), 0.15, np.float32))
            view = min(max(view, 0), nv - 1)
            rgb = self.last_outputs[self.rgb_key][self.world, view]
            d = self.last_outputs.get(self.depth_key)
            d = None if d is None else d[self.world, view]
            return png_bytes(rgbd_panel(rgb, d))

    def topdown_png(self) -> bytes:
        with self._lock:
            cols = self._bodies()
            img = render_topdown(cols["Position"], cols["Scale"],
                                 world=self.world, res=256)
        return png_bytes(img)

    def state_json(self) -> bytes:
        with self._lock:
            return json.dumps({
                "world": self.world,
                "step": self.step_count,
                "paused": self.paused,
                "cam": [float(v) for v in self.cam_pos]
                + [self.yaw, self.pitch],
                "num_worlds": self._num_worlds(),
                "num_views": self._num_views(),
            }).encode()

    # ------------------------------------------------------------- server

    def make_server(self, port: int = 0) -> ThreadingHTTPServer:
        def key(q):
            self.handle_key(q.get("k", [""])[0])
            return b"ok", "text/plain"

        return serve_routes({
            "/": lambda q: (_PAGE.encode(), "text/html"),
            "/frame.png": lambda q: (self.frame_png(), "image/png"),
            "/topdown.png": lambda q: (self.topdown_png(), "image/png"),
            "/agent.png": lambda q: (
                self.agent_png(int(q.get("v", ["0"])[0])), "image/png"),
            "/state": lambda q: (self.state_json(), "application/json"),
            "/key": key,
        }, port)

    def serve(self, port: int = 8787) -> None:
        """Blocking: run the sim loop and the HTTP server until Ctrl-C or
        :meth:`stop`."""
        srv = self.make_server(port)
        print(f"viewer at http://127.0.0.1:{srv.server_address[1]}/")
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            while not self._stop.is_set():
                t0 = time.time()
                self.tick()
                dt = 1.0 / self.fps - (time.time() - t0)
                if dt > 0:
                    time.sleep(dt)
        except KeyboardInterrupt:
            pass
        finally:
            srv.shutdown()
            srv.server_close()

    def stop(self) -> None:
        self._stop.set()
