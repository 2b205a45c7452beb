"""Viewer-lite: top-down world schematics and PNG output, no display
stack.

Port of ``madrona_tpu/viz/viewer.py``, in numpy: tensors come in
through ``.detach().cpu().numpy()``. :func:`render_topdown` draws the
body footprints of one world; :func:`save_frame_grid` tiles one world's
per-agent RGB views (Hide & Seek's ``rgb`` export) into one image.
:func:`png_bytes` is a dependency-free PNG encoder whose bytes equal the
JAX package's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def png_bytes(img) -> bytes:
    """Encode [H, W, 3] float [0, 1] or uint8 as PNG (the single encoder
    of save_png, the web viewer and the playback page)."""
    img = to_numpy(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    h, w, _ = img.shape
    raw = b"".join(
        b"\x00" + img[y].tobytes() for y in range(h)
    )

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data))

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )


def save_png(path: str, img) -> None:
    """img: [H, W, 3] float [0, 1] or uint8."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def render_topdown(
    positions, scales, colors=None, world=0, extent=None, res=512,
) -> np.ndarray:
    """Axis-aligned top-down footprint image of one world.

    positions [W, N, 3], scales [W, N, 3] (box half extents, used as the
    footprint), colors optional [N, 3]. Returns [res, res, 3] float32."""
    pos = to_numpy(positions)[world]
    sc = to_numpy(scales)[world]
    n = pos.shape[0]
    if colors is None:
        rs = np.random.RandomState(0)
        colors = 0.3 + 0.7 * rs.rand(n, 3)
    colors = to_numpy(colors)
    if extent is None:
        extent = float(np.abs(pos[:, :2]).max() + np.abs(sc[:, :2]).max())
    img = np.full((res, res, 3), 0.08, np.float32)

    def to_px(v):
        return np.clip(
            ((v / extent) * 0.5 + 0.5) * (res - 1), 0, res - 1
        ).astype(int)

    for i in range(n):
        x0, x1 = to_px(pos[i, 0] - sc[i, 0]), to_px(pos[i, 0] + sc[i, 0])
        y0, y1 = to_px(pos[i, 1] - sc[i, 1]), to_px(pos[i, 1] + sc[i, 1])
        img[res - 1 - y1:res - y0, x0:x1 + 1] = colors[i % len(colors)]
    return img


def save_frame_grid(path: str, rgb, world=0) -> None:
    """Tile one world's per-agent RGB views ([W, V, H, Wpx, 3]) into a
    single row image."""
    frames = to_numpy(rgb)[world]
    grid = np.concatenate(list(frames), axis=1)
    save_png(path, grid)
