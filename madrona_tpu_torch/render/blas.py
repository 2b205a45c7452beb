"""Mesh-BVH (BLAS) tier of the batch raycaster, plain PyTorch.

Port of ``madrona_tpu/render/blas.py``, its binary-tree tier: the
reference's TLAS -> BLAS walk (``bvh_raycast.cpp:225-520``) as an
ordered depth-first walk of each object's binary BVH, nearest child
first, a 48-deep stack per lane, vectorised over every (instance, ray)
lane. Triangles sit in BVH leaf order, so a leaf is the slice
``[first, first + count)``.

:func:`render_views_blas` is the tier's entry point. Where the raycast
kernel can shade the scene (``render/kernel.py::kernel_eligible``: a
flat triangle list within its budget, directional lights with at most
one shadow caster), it takes the kernel (``ops/raycast_cuda``, the
hand-written CUDA kernel on the card); everywhere else it walks the
BVHs here. Hide & Seek's ``render_tier="blas"`` takes the kernel.

The walk is the JAX package's ``lax.while_loop(any(sp > 0))`` as a
Python loop whose condition reads the stack pointers back to the host
once an iteration. That host sync is allowed here because this is the
plain tier, not a kernel's path.

Walkers (``cfg.blas_walker``), all with the same hits: "gather" walks
the binary tree by gathers; "onehot" (:func:`trace_rays_blas_onehot`)
is that walk too (the JAX package fetches the same rows by one-hot
matmuls for the TPU; the card gathers them); "wide"
(:func:`trace_rays_blas4`) walks the 4-wide collapse that
:func:`with_wide` attaches, its boxes in float32 or rounded outward to
bfloat16. "auto" takes the JAX package's CPU rule on every device:
"wide" where ``blas.wide`` is set, else "gather" (the JAX package picks
the one-hot walker off the CPU because of the TPU's gathers).

:func:`bake_assets_blas` bakes imported assets
(``assets.importer.ImportedAssets``) into the BLAS and material tables.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils import math3d as m3

# rays of a view traced together in the plain tier where
# ``RenderConfig.ray_chunk`` is 0: the whole view up to this many, else
# sequential chunks of this many (they bound the (instance, ray, stack)
# working set)
RAY_CHUNK = 1024
WALKERS = ("auto", "gather", "onehot", "wide")


@dataclasses.dataclass
class BlasTables:
    """Every render object's BVH as stacked padded tensors.

    Triangles are stored in BVH leaf order; ``left`` of a leaf node is
    the first triangle slot, ``right`` is ``-count``. Inner nodes store
    child indices. Padding nodes are empty leaves (count 0) with
    inverted boxes."""

    node_min: torch.Tensor   # [O, N, 3] f32
    node_max: torch.Tensor   # [O, N, 3] f32
    left: torch.Tensor       # [O, N] i32
    right: torch.Tensor      # [O, N] i32
    tri_v0: torch.Tensor     # [O, T, 3] f32 (leaf order)
    tri_e1: torch.Tensor     # [O, T, 3]
    tri_e2: torch.Tensor     # [O, T, 3]
    tri_color: torch.Tensor  # [O, T, 3]
    tri_uv: torch.Tensor     # [O, T, 3, 2] f32 (per-corner UVs)
    tri_mat: torch.Tensor    # [O, T] i32 material slot (0 = default)
    max_leaf: int = 4
    num_objects: int = 0
    # the 4-wide collapse (Blas4Tables, attached by with_wide): the
    # "auto" and "wide" walkers walk it; same hits
    wide: object = None

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[1]

    def to(self, device) -> "BlasTables":
        return _tables_to(self, device)


def _tables_to(tables, device):
    """A dataclass of tensors (and nested such tables) on ``device``."""
    def move(x):
        movable = torch.is_tensor(x) or dataclasses.is_dataclass(x)
        return x.to(device) if movable else x

    return dataclasses.replace(tables, **{
        f.name: move(getattr(tables, f.name))
        for f in dataclasses.fields(tables)})


def bake_blas(bvhs: Sequence, colors=None, tri_colors=None, uvs=None,
              materials=None, device=None) -> BlasTables:
    """Stack per-object ``assets.bvh.MeshBVH`` builds into BlasTables on
    ``device`` (default: the card).

    colors: per-object RGB (or ``tri_colors``: list of [T, 3] arrays in
    the original triangle order). uvs: per-object [V, 2] vertex UVs (or
    None). materials: per-object material slot (imported id + 1, 0 =
    default), the reference's per-leaf material index."""
    dev = resolve_device(device)
    o = len(bvhs)
    max_n = max(b.num_nodes for b in bvhs)
    max_t = max(len(b.indices) for b in bvhs)
    max_leaf = max(
        int(max(-b.right[b.right < 0])) if (b.right < 0).any() else 1
        for b in bvhs
    )
    # pad nodes: large finite inverted boxes, never hit by the slab test
    node_min = np.full((o, max_n, 3), 1e30, np.float32)
    node_max = np.full((o, max_n, 3), -1e30, np.float32)
    left = np.zeros((o, max_n), np.int32)
    right = np.zeros((o, max_n), np.int32)   # pad nodes: leaf count 0
    v0 = np.zeros((o, max_t, 3), np.float32)
    e1 = np.zeros((o, max_t, 3), np.float32)
    e2 = np.zeros((o, max_t, 3), np.float32)
    col = np.full((o, max_t, 3), 0.8, np.float32)
    uv = np.zeros((o, max_t, 3, 2), np.float32)
    mat = np.zeros((o, max_t), np.int32)
    for i, b in enumerate(bvhs):
        nn, nt = b.num_nodes, len(b.indices)
        node_min[i, :nn] = b.node_min
        node_max[i, :nn] = b.node_max
        left[i, :nn] = b.left
        right[i, :nn] = b.right
        order = b.tri_order                     # triangles in leaf order
        tri = b.indices[order]
        p = b.positions
        v0[i, :nt] = p[tri[:, 0]]
        e1[i, :nt] = p[tri[:, 1]] - p[tri[:, 0]]
        e2[i, :nt] = p[tri[:, 2]] - p[tri[:, 0]]
        if tri_colors is not None and tri_colors[i] is not None:
            col[i, :nt] = np.asarray(tri_colors[i], np.float32)[order]
        elif colors is not None:
            col[i, :nt] = np.asarray(colors[i], np.float32)
        if uvs is not None and uvs[i] is not None:
            uv[i, :nt] = np.asarray(uvs[i], np.float32)[tri]   # [T, 3, 2]
        if materials is not None:
            mat[i, :nt] = np.asarray(materials[i], np.int32)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return BlasTables(
        node_min=t(node_min), node_max=t(node_max), left=t(left),
        right=t(right), tri_v0=t(v0), tri_e1=t(e1), tri_e2=t(e2),
        tri_color=t(col), tri_uv=t(uv), tri_mat=t(mat),
        max_leaf=max_leaf, num_objects=o,
    )


def bake_assets_blas(assets, leaf_size: int = 4, tex_size: int = 64,
                     device=None):
    """(BlasTables, MaterialTables, object ids) of imported assets
    (``assets.importer.ImportedAssets``) on ``device`` (default: the
    card): one render object per imported mesh, built by the port's SAH
    builder, with its UVs and its material in slot ``material + 1`` (0 is
    the default white material); textures resampled to ``tex_size``
    (the reference's ``AssetProcessor::makeBVHData`` and
    ``initMaterialData``)."""
    from ..assets.bvh import build_mesh_bvh
    from .materials import bake_materials

    bvhs = [build_mesh_bvh(m.positions, m.indices, leaf_size)
            for m in assets.meshes]
    blas = bake_blas(bvhs, uvs=[m.uvs for m in assets.meshes],
                     materials=[m.material + 1 for m in assets.meshes],
                     device=device)
    mats = bake_materials(assets.materials, assets.textures,
                          tex_size=tex_size, device=device)
    return blas, mats, list(range(len(assets.meshes)))


@dataclasses.dataclass
class Blas4Tables:
    """The 4-wide collapse of :class:`BlasTables` (the reference's wide
    BVH nodes test several children together): half the tree's depth.

    Child entries (``c_entry``): >= 0 the index of a child wide node,
    < 0 the leaf slot ``-(entry) - 1`` into ``leaf_first`` /
    ``leaf_count``. Empty child slots carry inverted +inf/-inf boxes.
    ``c_min`` / ``c_max`` may be bfloat16, rounded outward at the bake
    (min down, max up), so that the rounding can only add node visits,
    never lose a hit; the triangles and their test stay float32."""

    c_min: torch.Tensor       # [O, N4, 4, 3] f32 or bf16
    c_max: torch.Tensor       # [O, N4, 4, 3]
    c_entry: torch.Tensor     # [O, N4, 4] i32
    leaf_first: torch.Tensor  # [O, L] i32
    leaf_count: torch.Tensor  # [O, L] i32
    tri_v0: torch.Tensor      # [O, T, 3] f32 (leaf order, shared)
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    max_leaf: int = 4

    def to(self, device) -> "Blas4Tables":
        return _tables_to(self, device)


def _bf16_bits(x):
    """bfloat16 bit patterns [0, 65535] (int64) of float32 ``x``, rounded
    to nearest even by torch's cast."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def _bf16_value(bits):
    """float32 of bfloat16 bit patterns (int64)."""
    w = bits << 16
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(
        torch.int32).view(torch.float32)


def _bf16_outward(lo, hi):
    """AABB bounds rounded outward to bfloat16 values (as float32): lo
    down, hi up. torch's cast rounds to nearest even; where that moved a
    bound inward it steps one bfloat16 ulp outward, by the sign bit (the
    next value below -0.0 or 0.0 is -min_bf16, 0x8001; above -0.0,
    +min_bf16, 0x0001). Infinities stay."""
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32)
    b = _bf16_bits(lo)
    neg = (b & 0x8000) != 0
    down = torch.where(neg, b + 1, torch.where(b == 0, 0x8001, b - 1))
    q = _bf16_value(b)
    lo_q = torch.where(q <= lo, q, _bf16_value(down))
    b = _bf16_bits(hi)
    neg = (b & 0x8000) != 0
    up = torch.where(neg, torch.where(b == 0x8000, 0x0001, b - 1), b + 1)
    q = _bf16_value(b)
    hi_q = torch.where(q >= hi, q, _bf16_value(up))
    return lo_q, hi_q


def widen_blas(blas: BlasTables, aabb_dtype: str = "float32") -> Blas4Tables:
    """Collapse each object's binary BVH into 4-wide nodes (on the host).

    Each binary inner node's children become: the child itself if it is
    a leaf, else its two children; up to 4 entries whose boxes are the
    binary nodes' own. The triangle tables are ``blas``'s (same leaf
    order), so the hits are the binary walker's."""
    nm, nx, lf, rt = (np.asarray(getattr(blas, k).cpu()) for k in
                      ("node_min", "node_max", "left", "right"))
    o = nm.shape[0]
    per_obj = []
    for i in range(o):
        leaves = []          # (first, count)
        wide = []            # each: list of (min3, max3, entry)
        wid_of = {}          # binary inner index -> wide index

        def leaf_slot(b):
            leaves.append((int(lf[i, b]), int(-rt[i, b])))
            return -len(leaves)          # -(slot) - 1, slot = len - 1

        def is_leaf(b):
            return rt[i, b] <= 0

        if is_leaf(0):
            wide.append([(nm[i, 0], nx[i, 0], leaf_slot(0))])
        else:
            wid_of[0] = 0
            wide.append(None)
            work = [0]
            while work:
                b = work.pop()
                kids = []
                for c in (int(lf[i, b]), int(rt[i, b])):
                    if is_leaf(c):
                        kids.append((nm[i, c], nx[i, c], leaf_slot(c)))
                        continue
                    for g in (int(lf[i, c]), int(rt[i, c])):
                        if is_leaf(g):
                            kids.append((nm[i, g], nx[i, g], leaf_slot(g)))
                            continue
                        if g not in wid_of:
                            wid_of[g] = len(wide)
                            wide.append(None)
                            work.append(g)
                        kids.append((nm[i, g], nx[i, g], wid_of[g]))
                wide[wid_of[b]] = kids
        per_obj.append((wide, leaves))

    n4 = max(len(w_) for w_, _ in per_obj)
    n_l = max(max(len(lv), 1) for _, lv in per_obj)
    cmin = np.full((o, n4, 4, 3), np.inf, np.float32)
    cmax = np.full((o, n4, 4, 3), -np.inf, np.float32)
    cent = np.zeros((o, n4, 4), np.int32)
    lfir = np.zeros((o, n_l), np.int32)
    lcnt = np.zeros((o, n_l), np.int32)
    for i, (wide, leaves) in enumerate(per_obj):
        for w_, kids in enumerate(wide):
            for k, (mn, mx, e) in enumerate(kids):
                cmin[i, w_, k] = mn
                cmax[i, w_, k] = mx
                cent[i, w_, k] = e
        lfir[i, :len(leaves)] = [a for a, _ in leaves]
        lcnt[i, :len(leaves)] = [c for _, c in leaves]
    dev = blas.node_min.device
    cmin_t, cmax_t = torch.from_numpy(cmin), torch.from_numpy(cmax)
    if aabb_dtype == "bfloat16":
        lo_q, hi_q = _bf16_outward(cmin_t, cmax_t)
        cmin_t, cmax_t = lo_q.to(torch.bfloat16), hi_q.to(torch.bfloat16)
    elif aabb_dtype != "float32":
        raise ValueError(f"aabb_dtype {aabb_dtype!r}: float32 or bfloat16")
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return Blas4Tables(
        c_min=cmin_t.to(dev), c_max=cmax_t.to(dev), c_entry=t(cent),
        leaf_first=t(lfir), leaf_count=t(lcnt), tri_v0=blas.tri_v0,
        tri_e1=blas.tri_e1, tri_e2=blas.tri_e2, max_leaf=blas.max_leaf)


def with_wide(blas: BlasTables, aabb_dtype: str = "float32") -> BlasTables:
    """``blas`` with the 4-wide collapse attached (the "auto" and "wide"
    walkers then walk it; the hits are the same)."""
    return dataclasses.replace(blas, wide=widen_blas(blas, aabb_dtype))


def _leaf_tris(fetch_tri, n_tris, max_leaf, first, count, o_l, d_l, best):
    """Masked Möller-Trumbore over a leaf's fixed budget of ``max_leaf``
    triangles from ``first`` (``count`` of them live a lane), into the
    running nearest hit ``best`` = [t, tri, u, v] (updated in place)."""
    for k in range(max_leaf):
        ti = torch.clamp(first + k, 0, n_tris - 1)
        valid = k < count
        v0, e1, e2 = fetch_tri(ti)
        p = m3.cross(d_l, e2)
        det = m3.dot(e1, p)
        inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
        tv = o_l - v0
        u = m3.dot(tv, p) * inv_det
        q = m3.cross(tv, e1)
        v = m3.dot(d_l, q) * inv_det
        t = m3.dot(e2, q) * inv_det
        hit = (
            valid & (torch.abs(det) > 1e-12)
            & (u >= 0) & (v >= 0) & (u + v <= 1)
            & (t > 1e-3) & (t < best[0])
        )
        best[1] = torch.where(hit, ti.to(torch.int32), best[1])
        best[2] = torch.where(hit, u, best[2])
        best[3] = torch.where(hit, v, best[3])
        best[0] = torch.where(hit, t, best[0])


def trace_rays_blas4(blas4: Blas4Tables, obj, o_l, d_l, live, t_max: float,
                     stack_size: int = 48):
    """The 4-wide walker; the contract of :func:`trace_rays_blas`.

    Stack entries: >= 1 a wide node's index + 1; <= -1 the leaf slot
    ``-e - 1`` (0 stays free as the empty filler). An inner node's hit
    children are sorted by their entry distance with a 5-comparator
    network and pushed farthest first, so the nearest pops first."""
    b = obj.shape[0]
    dev = o_l.device
    obj = obj.long()
    n_wide, n_leaf = blas4.c_entry.shape[1], blas4.leaf_first.shape[1]
    n_tris = blas4.tri_v0.shape[1]
    inv_d = torch.where(torch.abs(d_l) > 1e-12, 1.0 / d_l, 1e30)
    stack = torch.zeros((b, stack_size), dtype=torch.int32, device=dev)
    stack[:, 0] = live.to(torch.int32)             # the root, entry +1
    sp = live.to(torch.int64)
    best = [torch.full((b,), t_max, dtype=torch.float32, device=dev),
            torch.full((b,), -1, dtype=torch.int32, device=dev),
            torch.zeros((b,), dtype=torch.float32, device=dev),
            torch.zeros((b,), dtype=torch.float32, device=dev)]
    lanes = torch.arange(b, device=dev)

    def fetch_tri(ti):
        return (blas4.tri_v0[obj, ti], blas4.tri_e1[obj, ti],
                blas4.tri_e2[obj, ti])

    while bool((sp > 0).any()):
        active = sp > 0
        e = stack[lanes, torch.clamp(sp - 1, min=0)].long()
        sp = sp - active.long()
        is_leaf = e < 0

        # leaf lanes: the leaf's triangles
        slot = torch.clamp(torch.where(is_leaf, -e - 1, 0), max=n_leaf - 1)
        first = blas4.leaf_first[obj, slot].long()
        count = torch.where(is_leaf & active, blas4.leaf_count[obj, slot], 0)
        _leaf_tris(fetch_tri, n_tris, blas4.max_leaf, first, count, o_l, d_l,
                   best)

        # inner lanes: test the 4 children, push the hit ones far to near
        node = torch.clamp(torch.where(is_leaf | ~active, 0, e - 1), 0,
                           n_wide - 1)
        cmin = blas4.c_min[obj, node].float()               # [B, 4, 3]
        cmax = blas4.c_max[obj, node].float()
        t0 = (cmin - o_l[:, None, :]) * inv_d[:, None, :]
        t1 = (cmax - o_l[:, None, :]) * inv_d[:, None, :]
        lo = torch.minimum(t0, t1).amax(dim=-1)            # [B, 4]
        hi = torch.maximum(t0, t1).amin(dim=-1)
        enter = torch.clamp(lo, min=0.0)
        # empty slots carry inverted boxes, which a negative inv_d turns
        # into (-inf, inf): mask them explicitly
        cvalid = (cmax >= cmin).all(dim=-1)
        chit = cvalid & (hi >= enter) & (enter <= best[0][:, None])
        chit = chit & (~is_leaf & active)[:, None]
        ent = blas4.c_entry[obj, node]                      # [B, 4]
        enc = torch.where(ent >= 0, ent + 1, ent)
        dist = torch.where(chit, enter, float("inf"))
        d_ = list(dist.unbind(1))
        en_ = list(enc.unbind(1))
        h_ = list(chit.unbind(1))
        for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
            swap = d_[i] > d_[j]
            for a in (d_, en_, h_):
                a[i], a[j] = (torch.where(swap, a[j], a[i]),
                              torch.where(swap, a[i], a[j]))
        for k in (3, 2, 1, 0):                 # the farthest pushed first
            do = h_[k] & (sp < stack_size)
            pos = torch.clamp(sp, max=stack_size - 1)
            stack[lanes, pos] = torch.where(do, en_[k], stack[lanes, pos])
            sp = sp + do.long()
    return tuple(best)


def _slab(nmin, nmax, o, inv_d, t_best):
    """Ray-AABB slab test. All [B, 3] / [B]. Returns (enter, hit)."""
    t0 = (nmin - o) * inv_d
    t1 = (nmax - o) * inv_d
    lo = torch.minimum(t0, t1).amax(dim=-1)
    hi = torch.maximum(t0, t1).amin(dim=-1)
    enter = torch.clamp(lo, min=0.0)
    return enter, (hi >= enter) & (enter <= t_best)


def trace_rays_blas(blas: BlasTables, obj, o_l, d_l, live, t_max: float,
                    stack_size: int = 48):
    """Ordered depth-first BVH walk over all lanes, the near child popped
    first.

    obj [B] int object per lane; o_l / d_l [B, 3] the ray in the
    object's frame (d need not be unit); live [B] bool. Returns (t [B],
    tri [B] leaf-order slot or -1, u [B], v [B]): the nearest hit with t
    in (1e-3, t_max), as ``assets/bvh.py::MeshBVH.trace_ray``."""
    b = obj.shape[0]
    dev = o_l.device
    obj = obj.long()
    n_nodes, n_tris = blas.node_min.shape[1], blas.tri_v0.shape[1]
    inv_d = torch.where(torch.abs(d_l) > 1e-12, 1.0 / d_l, 1e30)
    stack = torch.zeros((b, stack_size), dtype=torch.int32, device=dev)
    sp = live.to(torch.int64)                       # root pushed if live
    best = [torch.full((b,), t_max, dtype=torch.float32, device=dev),
            torch.full((b,), -1, dtype=torch.int32, device=dev),
            torch.zeros((b,), dtype=torch.float32, device=dev),
            torch.zeros((b,), dtype=torch.float32, device=dev)]
    lanes = torch.arange(b, device=dev)

    def node_box(node):
        n = torch.clamp(node, 0, n_nodes - 1)       # masked lanes only
        return blas.node_min[obj, n], blas.node_max[obj, n]

    def fetch_tri(ti):
        return (blas.tri_v0[obj, ti], blas.tri_e1[obj, ti],
                blas.tri_e2[obj, ti])

    while bool((sp > 0).any()):
        active = sp > 0
        node = stack[lanes, torch.clamp(sp - 1, min=0)].long()
        sp = sp - active.long()

        _, node_hit = _slab(*node_box(node), o_l, inv_d, best[0])
        node_hit = node_hit & active
        lc = blas.left[obj, node].long()
        rc = blas.right[obj, node].long()
        is_leaf = rc <= 0

        # leaf: masked Möller-Trumbore over the fixed leaf budget
        count = torch.where(is_leaf & node_hit, -rc, 0)
        _leaf_tris(fetch_tri, n_tris, blas.max_leaf, lc, count, o_l, d_l,
                   best)

        # inner: push the children ordered (the near child pops first)
        push = node_hit & ~is_leaf
        lt, lhit = _slab(*node_box(lc), o_l, inv_d, best[0])
        rt, rhit = _slab(*node_box(rc), o_l, inv_d, best[0])
        lhit = lhit & push
        rhit = rhit & push
        l_near = lt <= rt
        first = torch.where(l_near, lc, rc).to(torch.int32)
        second = torch.where(l_near, rc, lc).to(torch.int32)
        f_hit = torch.where(l_near, lhit, rhit)
        s_hit = torch.where(l_near, rhit, lhit)
        # far child first; a full stack drops (sized never to happen)
        for val, want in ((second, s_hit), (first, f_hit)):
            do = want & (sp < stack_size)
            pos = torch.clamp(sp, max=stack_size - 1)
            stack[lanes, pos] = torch.where(do, val, stack[lanes, pos])
            sp = sp + do.long()
    return tuple(best)


# The JAX package's one-hot walker walks the same tree in the same order
# as its gather walker, fetching rows by one-hot matmuls because the TPU
# lacks fast gathers. The card gathers, so the port's one-hot walker is
# the gather walk: same contract, same hits.
trace_rays_blas_onehot = trace_rays_blas


def _take(a, idx):
    """a [..., I, ...] gathered along I by idx [..., R] -> [..., R, ...]."""
    lead = idx.dim()
    idx = idx.long().reshape(idx.shape + (1,) * (a.dim() - lead))
    return torch.take_along_dim(a, idx, dim=lead - 1)


def _trace_nearest(cfg, blas, inst_pos, inst_rot, inst_scale, inst_obj,
                   inst_mask, origins, dirs, t_max):
    """Nearest hit over all instances. Instances [..., I, ...], rays
    [..., R, 3]. Returns (depth [..., R], win [..., R] winning instance,
    tri [..., R] leaf slot or -1, u, v)."""
    walker = getattr(cfg, "blas_walker", "auto")
    if walker not in WALKERS:
        raise ValueError(f"unknown blas_walker {walker!r}")
    if walker == "auto":
        # the JAX package's CPU rule on every device (see the module doc)
        walker = "wide" if blas.wide is not None else "gather"
    inv_q = m3.quat_inv(inst_rot)[..., :, None, :]
    scale = torch.clamp(inst_scale, min=1e-12)[..., :, None, :]
    # the affine map keeps the ray's parameter: local t is world t
    o_l = m3.quat_rotate(
        inv_q, origins[..., None, :, :] - inst_pos[..., :, None, :]) / scale
    d_l = m3.quat_rotate(inv_q, dirs[..., None, :, :]) / scale
    shape = o_l.shape[:-1]                                  # [..., I, R]
    obj = inst_obj[..., :, None].expand(shape).reshape(-1)
    live = inst_mask[..., :, None].expand(shape).reshape(-1)
    if walker == "wide" and blas.wide is not None:
        trace = functools.partial(trace_rays_blas4, blas.wide)
    elif walker == "onehot":
        trace = functools.partial(trace_rays_blas_onehot, blas)
    else:
        trace = functools.partial(trace_rays_blas, blas)
    t, tri, u, v = trace(obj, o_l.reshape(-1, 3), d_l.reshape(-1, 3), live,
                         t_max)
    t, tri, u, v = (x.reshape(shape) for x in (t, tri, u, v))
    win = torch.argmin(t, dim=-2)                           # [..., R]
    depth = t.amin(dim=-2)
    pick = lambda x: torch.take_along_dim(x, win[..., None, :],  # noqa
                                          dim=-2)[..., 0, :]
    return depth, win, pick(tri), pick(u), pick(v)


def trace_scene_blas(cfg, blas: BlasTables, inst_pos, inst_rot, inst_scale,
                     inst_obj, inst_mask, origins, dirs, materials=None,
                     lights=None, shadow_scene=None):
    """Nearest hit over all instances by per-(instance, ray) walks, and
    its shading: (rgb [..., R, 3], depth [..., R]). Instances [..., I,
    ...], rays [..., R, 3].

    With ``materials`` (render.materials.MaterialTables) hits shade as
    base_color x texture(uv), otherwise by flat per-triangle colours.
    With ``lights`` (render.lights.Lights rows [..., L]) shading runs the
    reference's multi-light loop (directional and spot lights, shadows
    per light where ``cfg.shadows``); otherwise one fixed directional
    light, with ``cfg.shadows`` adding one occlusion trace toward it.

    ``shadow_scene``: an optional (pos, rot, scale, obj, mask) instance
    set for occlusion traces; callers that cull the primary set to a
    view frustum pass the full set here (occluders outside the frustum
    still cast shadows into it)."""
    depth, win, w_tri_raw, u, v = _trace_nearest(
        cfg, blas, inst_pos, inst_rot, inst_scale, inst_obj, inst_mask,
        origins, dirs, cfg.t_max,
    )
    hit_any = w_tri_raw >= 0
    w_obj = _take(inst_obj, win).long()
    w_tri = torch.clamp(w_tri_raw, min=0).long()

    n_l = m3.cross(blas.tri_e1[w_obj, w_tri], blas.tri_e2[w_obj, w_tri])
    n_w = m3.quat_rotate(
        _take(inst_rot, win),
        n_l / torch.clamp(_take(inst_scale, win), min=1e-12))
    n_w = n_w / torch.clamp(torch.sqrt(m3.dot(n_w, n_w)), min=1e-12)[
        ..., None]

    if materials is not None:
        from .materials import sample_materials

        uvs = blas.tri_uv[w_obj, w_tri]                   # [..., R, 3, 2]
        uv = (uvs[..., 0, :]
              + u[..., None] * (uvs[..., 1, :] - uvs[..., 0, :])
              + v[..., None] * (uvs[..., 2, :] - uvs[..., 0, :]))
        albedo = sample_materials(materials, blas.tri_mat[w_obj, w_tri], uv)
    else:
        albedo = blas.tri_color[w_obj, w_tri]

    sh = (shadow_scene if shadow_scene is not None
          else (inst_pos, inst_rot, inst_scale, inst_obj, inst_mask))

    def shadow_trace(s_org, s_dir, t_limit):
        """Occluded iff something is hit strictly before t_limit."""
        s_dep, _, s_tri, _, _ = _trace_nearest(cfg, blas, *sh, s_org, s_dir,
                                               cfg.t_max)
        return (s_tri >= 0) & (s_dep < t_limit)

    sky = torch.tensor(cfg.sky_color, dtype=torch.float32,
                       device=origins.device)
    if lights is not None:
        from .lights import light_contrib

        hit_p = origins + depth[..., None] * dirs
        contrib = light_contrib(lights, hit_p, n_w, hit_any, shadow_trace,
                                use_shadows=bool(cfg.shadows))
        # the reference: fmaxf(0.2, contrib) * colour, clamped; the floor
        # here is cfg.ambient
        shade = torch.clamp(contrib, min=float(cfg.ambient))
        rgb = torch.clamp(albedo * shade[..., None], 0.0, 1.0)
        rgb = torch.where(hit_any[..., None], rgb, sky)
        return rgb, torch.where(hit_any, depth, cfg.t_max)

    # one fixed directional light (no light table given)
    ld = np.array(cfg.light_dir) / np.linalg.norm(cfg.light_dir)
    light = -torch.tensor(ld, dtype=torch.float32, device=origins.device)
    ndl = m3.dot(n_w, light)
    lam = torch.abs(ndl)
    light_scale = torch.ones_like(lam)
    if cfg.shadows:
        hit_p = origins + depth[..., None] * dirs
        s_org = hit_p + n_w * torch.where(ndl >= 0, 1e-2, -1e-2)[..., None]
        occluded = shadow_trace(
            s_org, light.expand(s_org.shape),
            torch.full_like(depth, float("inf"))) & hit_any
        light_scale = torch.where(occluded, cfg.shadow_ambient, 1.0)
    shade = cfg.ambient + (1 - cfg.ambient) * lam * light_scale
    rgb = albedo * shade[..., None]
    rgb = torch.where(hit_any[..., None], rgb, sky)
    return rgb, torch.where(hit_any, depth, cfg.t_max)


def _render_chunk(cfg, blas, k, ip, ir, isc, io, ims, lt, cps, crs,
                  materials):
    """The plain tier for a chunk of worlds: instances [C, I, ...], view
    masks [C, V, I], lights [C, L] or None, cameras [C, V, ...]. Returns
    (rgb [C, V, H, Wpx, 3], depth [C, V, H, Wpx], overlap [C, V] or
    None)."""
    from .raycast import camera_rays, per_view

    h, w = cfg.height, cfg.width
    c, n_views = cps.shape[:2]
    # occlusion rays always see the full instance set
    shadow_scene = tuple(per_view(a, n_views) for a in (ip, ir, isc, io)) + (
        ims,)
    primary = shadow_scene
    overlap = None
    if k > 0:
        from .tlas import cull_view_topk, instance_world_aabbs

        # object AABBs: the BLAS root nodes (slot 0)
        lo, hi = instance_world_aabbs(blas.node_min[:, 0], blas.node_max[:, 0],
                                      ip, ir, isc, io)
        idx, ok, overlap = cull_view_topk(
            per_view(lo, n_views), per_view(hi, n_views), ims, cps, crs, k,
            cfg.fov_deg, w / h, cfg.t_max)
        primary = tuple(_take(a, idx) for a in shadow_scene[:4]) + (ok,)
    if lt is not None:
        lt = lt.map(lambda a: per_view(a, n_views))
    o, d = camera_rays(cfg, cps, crs)
    rays_o = o.reshape(c, n_views, h * w, 3)
    rays_d = d.reshape(c, n_views, h * w, 3)
    n_rays = h * w
    rc = cfg.ray_chunk or (n_rays if n_rays <= RAY_CHUNK else RAY_CHUNK)
    if rc < n_rays and n_rays % rc:
        raise ValueError(f"ray_chunk {rc} must divide the {n_rays} rays "
                         "of a view")
    # sequential ray chunks bound the (instance, ray, stack) working set;
    # exact, rays are independent
    outs = [
        trace_scene_blas(cfg, blas, *primary, rays_o[:, :, r0:r0 + rc],
                         rays_d[:, :, r0:r0 + rc], materials=materials,
                         lights=lt, shadow_scene=shadow_scene)
        for r0 in range(0, n_rays, rc)
    ]
    rgb = torch.cat([x[0] for x in outs], dim=2)
    dep = torch.cat([x[1] for x in outs], dim=2)
    return (rgb.reshape(c, n_views, h, w, 3), dep.reshape(c, n_views, h, w),
            overlap)


def render_views_blas(cfg, blas: BlasTables, inst_pos, inst_rot, inst_scale,
                      inst_obj, inst_mask, cam_pos, cam_rot, materials=None,
                      lights=None, max_instances_per_view: int = 0):
    """The BLAS-tier ``render_views`` ([W, ...] batches): instances
    [W, I, ...]; ``inst_mask`` [W, I] shared or [W, V, I] per view;
    cameras [W, V, ...]; ``lights`` a Lights table [W, L].

    ``max_instances_per_view`` > 0 culls each view to its K nearest
    instances whose world AABB (from the BLAS root nodes) meets the view
    frustum (``render/tlas.py::cull_view_topk``) before tracing, and
    returns an extra [W, V] overlap count for overflow detection. The
    kernel tier traces the full set and only computes that count."""
    from .raycast import per_view

    n_views = cam_pos.shape[1]
    if inst_mask.dim() == 2:
        inst_mask = per_view(inst_mask, n_views)
    k = max_instances_per_view

    from .kernel import (kernel_eligible, render_views_kernel,
                         view_overlap_counts)

    if kernel_eligible(cfg, blas, lights, k, inst_pos.shape[1]):
        out = render_views_kernel(
            cfg, blas, inst_pos, inst_rot, inst_scale, inst_obj, inst_mask,
            cam_pos, cam_rot, materials=materials, lights=lights,
        )
        if k > 0:
            overlap = view_overlap_counts(
                blas.node_min[:, 0], blas.node_max[:, 0], inst_pos, inst_rot,
                inst_scale, inst_obj, inst_mask, cam_pos, cam_rot, cfg)
            return out[0], out[1], overlap
        return out

    # chunks of 2^17 view-ray lanes bound the traversal's working set
    # (the JAX package's budget); sequential, exact
    n_worlds = inst_pos.shape[0]
    per_world_rays = n_views * cfg.height * cfg.width
    wc = max(1, min(n_worlds, (1 << 17) // max(per_world_rays, 1)))
    outs = []
    for c0 in range(0, n_worlds, wc):
        sl = slice(c0, c0 + wc)
        lt = None if lights is None else lights.map(lambda a: a[sl])
        outs.append(_render_chunk(
            cfg, blas, k, inst_pos[sl], inst_rot[sl], inst_scale[sl],
            inst_obj[sl], inst_mask[sl], lt, cam_pos[sl], cam_rot[sl],
            materials))
    rgb = torch.cat([o[0] for o in outs])
    dep = torch.cat([o[1] for o in outs])
    if k > 0:
        return rgb, dep, torch.cat([o[2] for o in outs])
    return rgb, dep
