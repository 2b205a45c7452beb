"""USD (.usda / .usd ASCII) mesh importer.

Port of ``madrona_tpu/assets/usd.py`` (which holds no JAX; the port
keeps its own copy). It reads ASCII USD stages directly (Mesh prims, fan
triangulation by faceVertexCounts, the leftHanded winding flip,
normals) and flattens the xform hierarchy (translate / scale /
rotateX|Y|Z / three-axis Euler ops / orient / transform, composed per
xformOpOrder and accumulated down nested Xforms). The reference's
``USDLoader::load`` parses a stage but imports no geometry.

Binary crate files (.usdc, and .usd files with the crate magic) are
refused with a ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from .importer import ImportedMesh

_DEF_RE = re.compile(r'\b(def|over)\s+(?:(\w+)\s+)?"([^"]+)"')
_ATTR_RE = re.compile(
    r'(?:uniform\s+|custom\s+)*'
    r'(matrix4d|double3|float3|double|float|int|normal3f|point3f|texCoord2f'
    r'|quatf|quatd|token|bool)'
    r'(\[\])?\s+([\w:]+)\s*=\s*'
)
_NUM_RE = re.compile(r'-?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?')


def _strip_comments(text: str) -> str:
    # '#' starts a comment outside strings; the '#usda 1.0' header is a
    # comment too. Strings in usda never span lines in the attrs we read.
    out = []
    for line in text.split("\n"):
        in_str = False
        for i, ch in enumerate(line):
            if ch == '"':
                in_str = not in_str
            elif ch == "#" and not in_str:
                line = line[:i]
                break
        out.append(line)
    return "\n".join(out)


def _match(text: str, i: int, open_ch: str, close_ch: str) -> int:
    """Index just past the bracket matching text[i] (which is open_ch)."""
    depth = 0
    in_str = False
    while i < len(text):
        ch = text[i]
        if ch == '"':
            in_str = not in_str
        elif not in_str:
            if ch == open_ch:
                depth += 1
            elif ch == close_ch:
                depth -= 1
                if depth == 0:
                    return i + 1
        i += 1
    raise ValueError(f"unbalanced {open_ch}{close_ch} in usda file")


@dataclasses.dataclass
class _Prim:
    kind: str                      # "Mesh", "Xform", "" (typeless), ...
    name: str
    attrs: str                     # body text excluding child prim blocks
    children: List["_Prim"]


def _parse_prims(body: str) -> List[_Prim]:
    return _parse_prims_ex(body)[0]


def _parse_prims_ex(body: str):
    """Parse child prims AND return the body text with their blocks
    removed — a prim's attrs may legally appear AFTER a nested child
    (exporters often emit GeomSubset/material children first), so
    truncating at the first ``def`` would drop them."""
    prims = []
    keep = []
    pos = 0
    cursor = 0
    while True:
        m = _DEF_RE.search(body, pos)
        if m is None:
            break
        i = m.end()
        # optional ( metadata ) block
        while i < len(body) and body[i].isspace():
            i += 1
        if i < len(body) and body[i] == "(":
            i = _match(body, i, "(", ")")
            while i < len(body) and body[i].isspace():
                i += 1
        if i >= len(body) or body[i] != "{":
            pos = m.end()
            continue
        end = _match(body, i, "{", "}")
        inner = body[i + 1:end - 1]
        children, attrs = _parse_prims_ex(inner)
        prims.append(_Prim(m.group(2) or "", m.group(3), attrs, children))
        keep.append(body[cursor:m.start()])
        cursor = end
        pos = end
    keep.append(body[cursor:])
    return prims, "".join(keep)


def _read_value(text: str, i: int) -> Tuple[str, int]:
    while i < len(text) and text[i] in " \t":
        i += 1
    if i >= len(text):
        return "", i
    ch = text[i]
    if ch == "[":
        j = _match(text, i, "[", "]")
    elif ch == "(":
        j = _match(text, i, "(", ")")
    elif ch == '"':
        j = text.index('"', i + 1) + 1
    else:
        j = i
        while j < len(text) and text[j] not in "\n,)":
            j += 1
    return text[i:j], j


def _attrs(prim_text: str) -> Dict[str, str]:
    out = {}
    pos = 0
    while True:
        m = _ATTR_RE.search(prim_text, pos)
        if m is None:
            return out
        val, pos = _read_value(prim_text, m.end())
        out[m.group(3)] = val


def _floats(val: str) -> np.ndarray:
    return np.asarray([float(x) for x in _NUM_RE.findall(val)], np.float64)


def _ints(val: str) -> np.ndarray:
    return np.asarray([int(x) for x in _NUM_RE.findall(val)], np.int64)


def _strings(val: str) -> List[str]:
    return re.findall(r'"([^"]*)"', val)


# ------------------------------------------------------------- transforms
# Column-vector convention here: p' = M @ p. USD's xformOpOrder lists ops
# outermost-first, so the local matrix is the left-to-right product of
# the listed ops (["translate","rotateXYZ","scale"] -> T @ R @ S).


def _rot_axis(axis: int, deg: float) -> np.ndarray:
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    m = np.eye(4)
    a, b = [(1, 2), (0, 2), (0, 1)][axis]
    m[a, a] = c
    m[b, b] = c
    if axis == 1:
        m[a, b] = s
        m[b, a] = -s
    else:
        m[a, b] = -s
        m[b, a] = s
    return m


def _quat_mat(w: float, x: float, y: float, z: float) -> np.ndarray:
    n = np.sqrt(w * w + x * x + y * y + z * z) or 1.0
    w, x, y, z = w / n, x / n, y / n, z / n
    m = np.eye(4)
    m[:3, :3] = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return m


def _op_matrix(op: str, attrs: Dict[str, str]) -> Optional[np.ndarray]:
    name = op[1:] if op.startswith("!invert!") else op
    if name not in attrs:
        return None
    v = _floats(attrs[name])
    kind = name.split(":")[1] if ":" in name else ""
    m = np.eye(4)
    if kind == "translate":
        m[:3, 3] = v[:3]
    elif kind == "scale":
        m[0, 0], m[1, 1], m[2, 2] = v[:3]
    elif len(kind) == 9 and kind.startswith("rotate") and set(
        kind[6:]
    ) == {"X", "Y", "Z"}:
        # three-axis Euler op rotate<ABC>: value components are per the
        # NAME's letters and geometry applies A then B then C, so
        # R = Rc @ Rb @ Ra (e.g. rotateZYX -> Rx @ Ry @ Rz)
        ax = {"X": 0, "Y": 1, "Z": 2}
        order = [ax[c] for c in kind[6:]]
        m = (
            _rot_axis(order[2], v[2])
            @ _rot_axis(order[1], v[1])
            @ _rot_axis(order[0], v[0])
        )
    # (the generic branch above also covers rotateXYZ)
    elif kind.startswith("rotateX"):
        m = _rot_axis(0, v[0])
    elif kind.startswith("rotateY"):
        m = _rot_axis(1, v[0])
    elif kind.startswith("rotateZ"):
        m = _rot_axis(2, v[0])
    elif kind == "orient":
        m = _quat_mat(*v[:4])                      # usda quats are (w,x,y,z)
    elif kind == "transform":
        # matrix4d is row-major with USD's row-vector convention
        m = v[:16].reshape(4, 4).T
    else:
        return None
    if op.startswith("!invert!"):
        m = np.linalg.inv(m)
    return m


def _local_matrix(attrs: Dict[str, str]) -> np.ndarray:
    order = _strings(attrs.get("xformOpOrder", ""))
    m = np.eye(4)
    for op in order:
        om = _op_matrix(op, attrs)
        if om is not None:
            m = m @ om
    return m


# ------------------------------------------------------------------ mesh


def _mesh_from_prim(prim: _Prim, world: np.ndarray) -> Optional[ImportedMesh]:
    attrs = _attrs(prim.attrs)
    if "points" not in attrs or "faceVertexIndices" not in attrs:
        return None
    pts = _floats(attrs["points"]).reshape(-1, 3)
    fvi = _ints(attrs["faceVertexIndices"])
    if "faceVertexCounts" in attrs:
        counts = _ints(attrs["faceVertexCounts"])
    else:
        counts = np.full(len(fvi) // 3, 3, np.int64)

    tris: List[Tuple[int, int, int]] = []
    off = 0
    for c in counts:
        for k in range(1, int(c) - 1):
            tris.append((int(fvi[off]), int(fvi[off + k]),
                         int(fvi[off + k + 1])))
        off += int(c)
    idx = np.asarray(tris, np.int32).reshape(-1, 3)
    if _strings(attrs.get("orientation", "")) == ["leftHanded"]:
        idx = idx[:, [0, 2, 1]]

    pos = (pts @ world[:3, :3].T + world[:3, 3]).astype(np.float32)
    nrm = np.zeros_like(pos)
    if "normals" in attrs:
        raw = _floats(attrs["normals"]).reshape(-1, 3)
        if len(raw) == len(pts):                   # vertex interpolation
            nit = np.linalg.inv(world[:3, :3]).T
            wn = raw @ nit.T
            ln = np.linalg.norm(wn, axis=1, keepdims=True)
            nrm = (wn / np.maximum(ln, 1e-12)).astype(np.float32)
    return ImportedMesh(pos, nrm, idx, prim.name)


def _walk(prims: List[_Prim], parent: np.ndarray,
          out: List[ImportedMesh]) -> None:
    for p in prims:
        world = parent @ _local_matrix(_attrs(p.attrs))
        if p.kind == "Mesh":
            m = _mesh_from_prim(p, world)
            if m is not None:
                out.append(m)
        _walk(p.children, world, out)


def load_usd(path: str) -> List[ImportedMesh]:
    """Import all Mesh prims from an ASCII USD stage, with the xform
    hierarchy flattened into world-space vertex positions."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(b"PXR-USDC"):
        raise ValueError(
            "binary usdc crate files are not supported (the reference's "
            "USD loader cannot import them either); export as .usda"
        )
    with open(path, encoding="utf-8") as f:
        text = f.read()
    out: List[ImportedMesh] = []
    _walk(_parse_prims(_strip_comments(text)), np.eye(4), out)
    return out
