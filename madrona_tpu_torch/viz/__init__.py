"""Viz: headless recorder and a lightweight viewer.

Port of ``madrona_tpu/viz`` (the reference's ``src/viz/``: the
interactive viewer and ``viz::Recorder``). The Recorder captures per-step
state or RGBD trajectories as numpy; the viewer renders top-down world
schematics or saved camera frames to PNG (a numpy PNG writer, no
display stack); the WebViewer serves the interactive loop (flycam,
pause/step, world switch, keyboard agent control) to a browser over the
stdlib's HTTP server, and the PlaybackViewer scrubs a saved trajectory.
"""

from .playback import PlaybackViewer
from .recorder import Recorder
from .viewer import render_topdown, save_png, save_frame_grid
from .web_viewer import WebViewer

__all__ = [
    "PlaybackViewer", "Recorder", "render_topdown", "save_png",
    "save_frame_grid", "WebViewer",
]
