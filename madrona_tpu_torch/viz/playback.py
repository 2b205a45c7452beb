"""Recorder playback: scrub a saved trajectory in the browser.

Port of ``madrona_tpu/viz/playback.py``, the offline half of the
reference's viewer loop: ``Recorder.save`` writes an .npz of ``[T, W,
...]`` arrays; :class:`PlaybackViewer` serves a page with a step slider,
play/pause, world switching, the live viewer's flycam (any step
re-rendered through the batch raycaster's dense tracer on ``device``
when mesh tables are given), a top-down schematic, and the recorded
per-agent RGBD views where the trajectory holds them.

Endpoints are stateless in the step index (``?t=``), so scrubbing is
image reloads; only the flycam lives on the server.

Usage::

    rec = Recorder(capture={"Position": ..., "Rotation": ..., ...})
    ... run the sim, rec.record(state, outputs) each step ...
    PlaybackViewer(rec.stacked(), mesh=mesh, render_obj=robj).serve()
    # or later: PlaybackViewer(Recorder.load("ep.npz"), ...)
"""

from __future__ import annotations

import json
import threading
from typing import Dict

import numpy as np

from ..core.device import resolve_device
from .viewer import png_bytes, render_topdown, to_numpy
from .web_viewer import Flycam, frame_renderer, rgbd_panel, serve_routes

_PAGE = """<!doctype html>
<html><head><title>madrona_tpu playback</title><style>
body { background: #111; color: #ddd; font-family: monospace; }
img { image-rendering: pixelated; border: 1px solid #444; }
#hud { margin: 8px 0; }
#agents img { height: 128px; margin-right: 4px; }
#bar { width: 640px; }
</style></head><body>
<div id="hud">loading…</div>
<div><input type="range" id="bar" min="0" max="0" value="0">
<button id="play">play</button></div>
<img id="cam" width="640" height="480">
<img id="top" width="480" height="480">
<div id="agents"></div>
<div>W/A/S/D move · Q/E down/up · arrows look · [ ] world ·
,/. step back/fwd · Space play/pause</div>
<script>
let meta = null, t = 0, world = 0, playing = false;
const bar = document.getElementById('bar');
function show() {
  const n = Date.now();
  if (meta.has_cam)
    document.getElementById('cam').src = `/frame.png?t=${t}&w=${world}&n=${n}`;
  if (meta.has_topdown)
    document.getElementById('top').src = `/topdown.png?t=${t}&w=${world}&n=${n}`;
  for (let v = 0; v < meta.num_views; v++)
    document.getElementById('agent' + v).src =
      `/agent.png?t=${t}&w=${world}&v=${v}&n=${n}`;
  document.getElementById('hud').textContent =
    `step ${t}/${meta.steps - 1}  world ${world}` +
    (playing ? '  PLAYING' : '');
  bar.value = t;
}
async function boot() {
  meta = await (await fetch('/meta')).json();
  bar.max = meta.steps - 1;
  const row = document.getElementById('agents');
  for (let v = 0; v < meta.num_views; v++) {
    const im = document.createElement('img');
    im.id = 'agent' + v;
    row.appendChild(im);
  }
  if (!meta.has_cam) document.getElementById('cam').style.display = 'none';
  show();
}
bar.addEventListener('input', () => { t = +bar.value; show(); });
document.getElementById('play').addEventListener('click', () => {
  playing = !playing;
});
setInterval(() => {
  if (playing && meta) { t = (t + 1) % meta.steps; show(); }
}, 100);
document.addEventListener('keydown', async e => {
  if (!meta) return;
  if (e.key === '.') { t = Math.min(t + 1, meta.steps - 1); show(); }
  else if (e.key === ',') { t = Math.max(t - 1, 0); show(); }
  else if (e.key === ' ') { playing = !playing; e.preventDefault(); }
  else if (e.key === '[') { world = Math.max(world - 1, 0); show(); }
  else if (e.key === ']') {
    world = Math.min(world + 1, meta.num_worlds - 1); show();
  } else {
    await fetch('/key?k=' + encodeURIComponent(e.key));
    show();
    if (['ArrowUp', 'ArrowDown'].includes(e.key)) e.preventDefault();
  }
});
boot();
</script></body></html>"""


class PlaybackViewer(Flycam):
    """Serve a recorded trajectory for scrubbing.

    Parameters
    ----------
    traj: dict of ``[T, ...]`` arrays or tensors (``Recorder.stacked()``
        / ``Recorder.load``). Body state under ``pos_key``/``rot_key``/
        ``scale_key`` (each ``[T, W, N, ...]``) enables the flycam
        re-render (with ``mesh`` and ``render_obj``) and the top-down
        view; ``rgb_key``/``depth_key`` (``[T, W, V, H, Wd, ...]``)
        enable the agent RGBD panels.
    mesh: render.MeshTables for re-rendering (optional)
    render_obj: [N] int render object per body row (with ``mesh``)
    device: where frames are traced (default: the card,
        ``core/device.resolve_device``)
    """

    def __init__(self, traj: Dict[str, np.ndarray], mesh=None,
                 render_obj=None, body_mask=None,
                 width: int = 320, height: int = 240, fov_deg: float = 90.0,
                 pos_key: str = "Position", rot_key: str = "Rotation",
                 scale_key: str = "Scale",
                 rgb_key: str = "rgb", depth_key: str = "depth",
                 device=None):
        super().__init__()
        self.traj = {k: to_numpy(v) for k, v in traj.items()}
        self.pos_key, self.rot_key, self.scale_key = (
            pos_key, rot_key, scale_key
        )
        self.rgb_key, self.depth_key = rgb_key, depth_key
        self._lock = threading.Lock()
        self.width, self.height = width, height

        self.steps = max(
            (int(v.shape[0]) for v in self.traj.values()), default=0
        )
        pos = self.traj.get(pos_key)
        rgb = self.traj.get(rgb_key)
        self.num_worlds = int(
            pos.shape[1] if pos is not None
            else rgb.shape[1] if rgb is not None else 1
        )
        self.num_views = int(
            rgb.shape[2]
        ) if rgb is not None and rgb.ndim >= 6 else 0

        self._frame = None
        if mesh is not None and render_obj is not None and pos is not None:
            self._frame = frame_renderer(
                width, height, fov_deg, mesh, render_obj, body_mask,
                resolve_device(device))

    # ------------------------------------------------------------- frames

    def _clamp(self, t: int, w: int):
        return (
            min(max(t, 0), self.steps - 1),
            min(max(w, 0), self.num_worlds - 1),
        )

    def has_topdown(self) -> bool:
        return self.pos_key in self.traj and self.scale_key in self.traj

    def frame(self, t: int, world: int):
        """The flycam's (rgb [H, W, 3], depth [H, W]) of step ``t``,
        world ``world``, on the viewer's device."""
        t, world = self._clamp(t, world)
        with self._lock:
            return self._frame(
                self.traj[self.pos_key][t, world],
                self.traj[self.rot_key][t, world],
                self.traj[self.scale_key][t, world],
                self.cam_pos, self.cam_quat())

    def frame_png(self, t: int, world: int) -> bytes:
        return png_bytes(self.frame(t, world)[0])

    def topdown_png(self, t: int, world: int) -> bytes:
        t, world = self._clamp(t, world)
        img = render_topdown(
            self.traj[self.pos_key][t],
            self.traj[self.scale_key][t],
            world=world, res=256,
        )
        return png_bytes(img)

    def agent_png(self, t: int, world: int, view: int) -> bytes:
        t, world = self._clamp(t, world)
        view = min(max(view, 0), self.num_views - 1)
        rgb = self.traj[self.rgb_key][t, world, view]
        d = self.traj.get(self.depth_key)
        d = None if d is None else d[t, world, view]
        return png_bytes(rgbd_panel(rgb, d))

    def meta_json(self) -> bytes:
        return json.dumps({
            "steps": self.steps,
            "num_worlds": self.num_worlds,
            "num_views": self.num_views,
            "has_cam": self._frame is not None,
            "has_topdown": self.has_topdown(),
            "keys": sorted(self.traj.keys()),
        }).encode()

    def handle_key(self, k: str) -> None:
        """The flycam's keys of the live viewer's controls."""
        with self._lock:
            self.move(k)

    # ------------------------------------------------------------- server

    def make_server(self, port: int = 0):
        def geti(q, k):
            return int(q.get(k, ["0"])[0])

        def key(q):
            self.handle_key(q.get("k", [""])[0])
            return b"ok", "text/plain"

        return serve_routes({
            "/": lambda q: (_PAGE.encode(), "text/html"),
            "/meta": lambda q: (self.meta_json(), "application/json"),
            "/frame.png": lambda q: None if self._frame is None else (
                self.frame_png(geti(q, "t"), geti(q, "w")), "image/png"),
            "/topdown.png": lambda q: None if not self.has_topdown() else (
                self.topdown_png(geti(q, "t"), geti(q, "w")), "image/png"),
            "/agent.png": lambda q: None if not self.num_views else (
                self.agent_png(geti(q, "t"), geti(q, "w"), geti(q, "v")),
                "image/png"),
            "/key": key,
        }, port)

    def serve(self, port: int = 8788) -> None:
        """Blocking: serve until Ctrl-C."""
        srv = self.make_server(port)
        print(f"playback at http://127.0.0.1:{srv.server_address[1]}/")
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.shutdown()
            srv.server_close()
