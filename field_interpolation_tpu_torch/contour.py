"""Iso-contours and iso-surfaces of solved fields.

Counterpart of ``field_interpolation_tpu.contour``, in two halves:

* Host, in NumPy (float64): `marching_squares` (16 cases, saddles resolved
  by the cell-centre sign), `marching_tetrahedra` (each cube cell split
  into 6 tetrahedra), `weld_triangles`, `write_obj`, `contour_polylines`.
  They also take torch tensors (``.detach().cpu().numpy()``). Same
  arithmetic and output order as the reference.
* Device, in torch on the field's own device: `marching_squares_device` /
  `marching_tetrahedra_device` give a fixed slot layout (two segments per
  cell, twelve triangles per cell) and its ``valid`` mask, in float32
  after the level shift; the ``*_compact`` forms stream tiles of cells
  through the same slot extraction and keep only the live items, in the
  full-slot stream order, in a capped buffer. The compact forms take a
  leading lane axis (``[B, H, W]``, ``[B, NI, NJ, NK]``): every lane in
  one call, each lane's output its own call's.

Coordinates are lattice coordinates: vertex (r, c) is row r, column c, as
sample positions are (SPEC.md).
"""

from __future__ import annotations

import functools
from collections import defaultdict

import numpy as np
import torch

# Marching-squares: cell corners indexed
#   0: (r, c)   1: (r, c+1)   2: (r+1, c+1)   3: (r+1, c)
# edges: 0: 0-1 (top), 1: 1-2 (right), 2: 3-2 (bottom), 3: 0-3 (left)
_MS_EDGES = {
    0: [], 15: [],
    1: [(3, 0)], 14: [(3, 0)],
    2: [(0, 1)], 13: [(0, 1)],
    4: [(1, 2)], 11: [(1, 2)],
    8: [(2, 3)], 7: [(2, 3)],
    3: [(3, 1)], 12: [(3, 1)],
    6: [(0, 2)], 9: [(0, 2)],
    # saddles resolved by cell-center sign below
    5: None, 10: None,
}

_EDGE_CORNERS = {0: (0, 1), 1: (1, 2), 2: (3, 2), 3: (0, 3)}
_CORNER_OFFSET = np.array([(0, 0), (0, 1), (1, 1), (1, 0)], dtype=np.float64)

# Marching tetrahedra: each cube cell split into 6 tets sharing the main
# diagonal 0-6; corner k's offsets apply to axes (0, 1, 2).
_CUBE_CORNERS = np.array([
    (0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
    (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0),
], dtype=np.float64)
_TETS = [
    (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
    (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6),
]


def _host(a) -> np.ndarray:
    """A NumPy array of ``a``: a torch tensor is detached and copied to the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---- host -----------------------------------------------------------------

def marching_squares(field, level: float = 0.0) -> np.ndarray:
    """Extract the iso-contour of a 2D field (NumPy array or torch tensor).

    Returns segments [n, 2, 2] of (row, col) endpoints in lattice coords.
    """
    f = np.asarray(_host(field), dtype=np.float64) - level
    H, W = f.shape
    segments = []

    def edge_point(r, c, e):
        a, b = _EDGE_CORNERS[e]
        pa = _CORNER_OFFSET[a] + (r, c)
        pb = _CORNER_OFFSET[b] + (r, c)
        va = f[int(pa[0]), int(pa[1])]
        vb = f[int(pb[0]), int(pb[1])]
        t = 0.5 if va == vb else va / (va - vb)
        return pa + t * (pb - pa)

    for r in range(H - 1):
        for c in range(W - 1):
            corners = (f[r, c], f[r, c + 1], f[r + 1, c + 1], f[r + 1, c])
            case = sum(1 << i for i, v in enumerate(corners) if v < 0)
            edges = _MS_EDGES[case]
            if edges is None:  # saddle: use cell-center average sign
                center_neg = sum(corners) < 0
                if case == 5:
                    edges = [(0, 1), (2, 3)] if center_neg else [(3, 0), (1, 2)]
                else:  # case 10
                    edges = [(3, 0), (1, 2)] if center_neg else [(0, 1), (2, 3)]
            for e0, e1 in edges:
                segments.append((edge_point(r, c, e0), edge_point(r, c, e1)))
    return (np.asarray(segments, dtype=np.float64) if segments
            else np.zeros((0, 2, 2)))


def marching_tetrahedra(field, level: float = 0.0) -> np.ndarray:
    """Extract the iso-surface of a 3D field (NumPy array or torch tensor)
    as a triangle soup.

    Returns triangles [n, 3, 3] of (i, j, k) vertices in lattice coords.
    """
    f = np.asarray(_host(field), dtype=np.float64) - level
    NI, NJ, NK = f.shape
    tris = []

    def interp(p0, p1, v0, v1):
        t = 0.5 if v0 == v1 else v0 / (v0 - v1)
        return p0 + t * (p1 - p0)

    for i in range(NI - 1):
        for j in range(NJ - 1):
            for k in range(NK - 1):
                base = np.array((i, j, k), dtype=np.float64)
                pts = _CUBE_CORNERS + base
                vals = np.array([f[int(p[0]), int(p[1]), int(p[2])] for p in pts])
                if vals.min() >= 0 or vals.max() < 0:
                    continue
                for tet in _TETS:
                    tp = pts[list(tet)]
                    tv = vals[list(tet)]
                    neg = [t for t in range(4) if tv[t] < 0]
                    if len(neg) == 0 or len(neg) == 4:
                        continue
                    pos = [t for t in range(4) if tv[t] >= 0]
                    if len(neg) == 1 or len(pos) == 1:
                        # one apex vs a triangle base -> one triangle
                        apex = neg[0] if len(neg) == 1 else pos[0]
                        others = [t for t in range(4) if t != apex]
                        tri = [interp(tp[apex], tp[o], tv[apex], tv[o])
                               for o in others]
                        tris.append(tri)
                    else:
                        # 2-2 split -> quad -> two triangles
                        a, b = neg
                        c, d = pos
                        q = [interp(tp[a], tp[c], tv[a], tv[c]),
                             interp(tp[a], tp[d], tv[a], tv[d]),
                             interp(tp[b], tp[d], tv[b], tv[d]),
                             interp(tp[b], tp[c], tv[b], tv[c])]
                        tris.append([q[0], q[1], q[2]])
                        tris.append([q[0], q[2], q[3]])
    return (np.asarray(tris, dtype=np.float64) if tris
            else np.zeros((0, 3, 3)))


def weld_triangles(triangles,
                   weld_tol: float = 1e-5) -> tuple[np.ndarray, np.ndarray]:
    """Triangle soup [n, 3, 3] (NumPy array or torch tensor) → indexed mesh
    ``(vertices [m, 3] float64, faces [n, 3] int)``: coincident vertices
    (rounded to ``weld_tol``) are welded so shared edges are truly shared."""
    tris = np.asarray(_host(triangles), dtype=np.float64)
    if tris.ndim != 3 or tris.shape[1:] != (3, 3):
        raise ValueError(f"expected [n, 3, 3] triangles, got {tris.shape}")
    flat = tris.reshape(-1, 3)
    keys = np.round(flat / weld_tol).astype(np.int64)
    # representative coordinates: first occurrence of each welded vertex
    _, first, inv = np.unique(keys, axis=0, return_index=True,
                              return_inverse=True)
    return flat[first], inv.reshape(-1, 3)


def write_obj(path: str, triangles,
              weld_tol: float = 1e-5) -> tuple[int, int]:
    """Write a triangle soup [n, 3, 3] to a Wavefront OBJ file, welding
    coincident vertices (`weld_triangles`). Returns (num_vertices,
    num_triangles)."""
    verts, faces = weld_triangles(triangles, weld_tol)
    with open(path, "w") as fh:
        fh.write("# field_interpolation_tpu iso-surface\n")
        for v in verts:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
    return len(verts), len(faces)


def contour_polylines(segments, tol: float = 1e-9) -> list[np.ndarray]:
    """Chain marching-squares segments [n, 2, 2] (NumPy array or torch
    tensor) into polylines (closed where possible)."""
    segments = np.asarray(_host(segments))
    if len(segments) == 0:
        return []
    segs = [(tuple(s[0]), tuple(s[1])) for s in np.round(segments / tol) * tol]
    adj = defaultdict(list)
    for i, (a, b) in enumerate(segs):
        adj[a].append(i)
        adj[b].append(i)
    used = [False] * len(segs)
    lines = []
    for start in range(len(segs)):
        if used[start]:
            continue
        used[start] = True
        a, b = segs[start]
        chain = [a, b]

        def extend(cur, append):
            while True:
                nxt = [i for i in adj[cur] if not used[i]]
                if not nxt:
                    return
                i = nxt[0]
                used[i] = True
                p, q = segs[i]
                cur = q if p == cur else p
                append(cur)

        extend(b, chain.append)
        # An open contour whose seed segment sits mid-chain also needs the
        # backward walk from the seed's first endpoint (closed loops consume
        # every segment in the forward walk, so this is a no-op for them).
        extend(a, lambda p: chain.insert(0, p))
        lines.append(np.asarray(chain))
    return lines


# ---- device: fixed slots --------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ms_tables():
    """(tableA, tableB): [16, 2, 2] int32 edge-pair tables for up to two
    segments per cell; -1 marks an empty slot. tableA applies when the
    cell-center average is >= 0, tableB when it is negative (they differ
    only in the saddle cases 5 and 10)."""
    A = -np.ones((16, 2, 2), dtype=np.int32)
    B = -np.ones((16, 2, 2), dtype=np.int32)
    for case, edges in _MS_EDGES.items():
        if edges is None:
            continue
        for si, (e0, e1) in enumerate(edges):
            A[case, si] = (e0, e1)
            B[case, si] = (e0, e1)
    A[5], B[5] = [(3, 0), (1, 2)], [(0, 1), (2, 3)]
    A[10], B[10] = [(0, 1), (2, 3)], [(3, 0), (1, 2)]
    A.setflags(write=False)
    B.setflags(write=False)
    return A, B


def _shifted(field: torch.Tensor, level: float) -> torch.Tensor:
    """``field - level`` in the field's dtype, then float32."""
    return (field - torch.tensor(level, dtype=field.dtype, device=field.device)
            ).to(torch.float32)


def _t_of(va: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """The crossing's fraction va / (va − vb) along an edge, 0.5 where the
    corners are equal (both sides are evaluated, so the denominator is
    guarded)."""
    d = va - vb
    zero = d == 0
    return torch.where(zero, 0.5, va / torch.where(zero, 1.0, d))


def _iota(n: int, base: float, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device) + base


def marching_squares_device(field: torch.Tensor, level: float = 0.0):
    """Marching squares on the field's device.

    field: [H, W] tensor (any float dtype). Returns ``(segments
    [(H-1)·(W-1)·2, 2, 2] float32, valid [(H-1)·(W-1)·2] bool)`` in (row,
    col) lattice coordinates: the fixed slot layout holds up to two
    segments per cell (row-major cells); ``valid`` masks the live slots.
    ``segments[valid]`` is the host `marching_squares` output up to segment
    order. For large grids use `marching_squares_device_compact`.
    """
    return _ms_slots(_shifted(field, level), 0.0)


def _ms_slots(f: torch.Tensor, base_r: float, base_c: float | None = None):
    """Fixed-slot marching squares on an (already level-shifted) float32
    field ``f [..., h, W]`` (leading axes are lanes); segment coordinates
    are offset by ``base_r``/``base_c`` so that tiled and sharded callers
    emit global coordinates. Returns (segments [..., cells·2, 2, 2], valid
    [..., cells·2])."""
    lead, (H, W) = f.shape[:-2], f.shape[-2:]
    v0 = f[..., :-1, :-1]
    v1 = f[..., :-1, 1:]
    v2 = f[..., 1:, 1:]
    v3 = f[..., 1:, :-1]
    case = ((v0 < 0).long() + 2 * (v1 < 0).long() + 4 * (v2 < 0).long()
            + 8 * (v3 < 0).long())                      # [..., H-1, W-1]
    center_neg = (((v0 + v1) + v2) + v3) < 0

    rr = _iota(H - 1, base_r, f.device)[:, None].expand(H - 1, W - 1)
    cc = torch.arange(W - 1, dtype=torch.float32, device=f.device)
    if base_c is not None:
        cc = cc + base_c
    cc = cc[None, :].expand(H - 1, W - 1)
    # Edge interpolation points, indexed like _EDGE_CORNERS (top/right/
    # bottom/left), stacked as [..., H-1, W-1, 4 edges, 2 (row, col)].
    p_top = torch.stack(torch.broadcast_tensors(rr, cc + _t_of(v0, v1)), -1)
    p_right = torch.stack(torch.broadcast_tensors(rr + _t_of(v1, v2), cc + 1.0), -1)
    p_bottom = torch.stack(torch.broadcast_tensors(rr + 1.0, cc + _t_of(v3, v2)), -1)
    p_left = torch.stack(torch.broadcast_tensors(rr + _t_of(v0, v3), cc), -1)
    epts = torch.stack([p_top, p_right, p_bottom, p_left], dim=-2)

    # tableA for a cell-centre average >= 0, tableB below, as one [32, 4]
    # int8 table: on the H100 a lookup into an int64 table was the slowest
    # step of the extraction (PERF.md).
    tables = torch.tensor(np.concatenate(_ms_tables()).reshape(32, 4), dtype=torch.int8,
                          device=f.device)
    key = (case + 16 * center_neg.long()).reshape(-1)
    edges = tables.index_select(0, key).reshape(case.shape + (2, 2)).long()  # [..., 2, 2]
    valid = edges[..., 0] >= 0                          # [..., H-1, W-1, 2]
    safe = edges.clamp(min=0)
    # The two endpoints of each slot's edge pair: [..., 2 slots, 2 ends, 2].
    src = epts[..., None, :, :].expand(*epts.shape[:-2], 2, 4, 2)
    segs = torch.gather(src, -2, safe[..., None].expand(*safe.shape, 2))
    n_slots = (H - 1) * (W - 1) * 2
    return segs.reshape(*lead, n_slots, 2, 2), valid.reshape(*lead, n_slots)


@functools.lru_cache(maxsize=None)
def _mt_table():
    """[16, 2, 3, 2] int32: per tet sign-case (bit t = corner t negative),
    up to two triangles of three edge-interpolation points, each edge a
    (corner_a, corner_b) pair of tet-local indices (interp order: value at
    corner_a first, exactly like the host marching_tetrahedra); -1 marks
    empty slots."""
    T = -np.ones((16, 2, 3, 2), dtype=np.int32)
    for case in range(1, 15):
        neg = [t for t in range(4) if (case >> t) & 1]
        pos = [t for t in range(4) if not (case >> t) & 1]
        if len(neg) == 1 or len(pos) == 1:
            apex = neg[0] if len(neg) == 1 else pos[0]
            others = [t for t in range(4) if t != apex]
            T[case, 0] = [(apex, o) for o in others]
        else:  # 2-2 split -> quad -> two triangles
            a, b = neg
            c, d = pos
            q = [(a, c), (a, d), (b, d), (b, c)]
            T[case, 0] = [q[0], q[1], q[2]]
            T[case, 1] = [q[0], q[2], q[3]]
    T.setflags(write=False)
    return T


def marching_tetrahedra_device(field: torch.Tensor, level: float = 0.0):
    """Marching tetrahedra on the field's device.

    field: [NI, NJ, NK] tensor. Returns ``(triangles [n_cells·12, 3, 3]
    float32, valid [n_cells·12] bool)``: a fixed slot layout of 6 tets × up
    to 2 triangles per cell (row-major cells, tets in _TETS order);
    ``triangles[valid]`` is the host `marching_tetrahedra` triangle set.
    The slots are 12·9 floats a cell (~900 MB at 128³, several GB of
    intermediates); for large fields use
    `marching_tetrahedra_device_compact`.
    """
    return _mt_slots(_shifted(field, level), 0.0)


def _mt_slots(f: torch.Tensor, base_i: float, base_j: float | None = None,
              base_k: float | None = None):
    """Fixed-slot marching tetrahedra on an (already level-shifted) float32
    field ``f [..., ni, NJ, NK]`` (leading axes are lanes); triangle
    coordinates are offset by ``base_i`` (and ``base_j``/``base_k``).
    Returns (tris [..., cells·12, 3, 3], valid [..., cells·12])."""
    lead, (NI, NJ, NK) = f.shape[:-3], f.shape[-3:]
    dev = f.device
    cells = (NI - 1) * (NJ - 1) * (NK - 1)
    corner = _CUBE_CORNERS.astype(np.int64)                       # [8, 3]
    vals8 = torch.stack(
        [f[..., o0:NI - 1 + o0, o1:NJ - 1 + o1, o2:NK - 1 + o2]
         for (o0, o1, o2) in corner], dim=-1).reshape(*lead, cells, 8)

    ii = _iota(NI - 1, base_i, dev)
    jj = torch.arange(NJ - 1, dtype=torch.float32, device=dev)
    kk = torch.arange(NK - 1, dtype=torch.float32, device=dev)
    if base_j is not None:
        jj = jj + base_j
    if base_k is not None:
        kk = kk + base_k
    base = torch.stack(torch.meshgrid(ii, jj, kk, indexing="ij"), -1).reshape(cells, 1, 3)
    pos8 = base + torch.as_tensor(_CUBE_CORNERS, dtype=torch.float32, device=dev)

    tets = torch.as_tensor(_TETS, device=dev).reshape(-1)           # [24]
    tv = vals8.index_select(-1, tets).reshape(*lead, cells, 6, 4)
    tp = pos8.index_select(1, tets).reshape(cells, 6, 4, 3)
    case = ((tv < 0).long() * torch.tensor([1, 2, 4, 8], device=dev)).sum(-1)

    # The table as int8, as in `_ms_slots`.
    table = torch.tensor(_mt_table().reshape(16, 12), dtype=torch.int8, device=dev)
    tab = table.index_select(0, case.reshape(-1)).reshape(
        case.shape + (2, 3, 2)).long()                               # [..., cells, 6, 2, 3, 2]
    valid = tab[..., 0, 0] >= 0                                      # [..., cells, 6, 2]
    safe = tab.clamp(min=0)

    def corner_values(idx):                 # [..., cells, 6, 2, 3] of tv
        return torch.gather(tv, -1, idx.reshape(*idx.shape[:-2], 6)).reshape(idx.shape)

    def corner_points(idx):                 # [..., cells, 6, 2, 3, 3] of tp
        flat = idx.reshape(*idx.shape[:-2], 6)[..., None].expand(*idx.shape[:-2], 6, 3)
        src = tp.expand(*lead, cells, 6, 4, 3)
        return torch.gather(src, -2, flat).reshape(*idx.shape, 3)

    va, vb = corner_values(safe[..., 0]), corner_values(safe[..., 1])
    pa, pb = corner_points(safe[..., 0]), corner_points(safe[..., 1])
    tris = pa + _t_of(va, vb)[..., None] * (pb - pa)                 # [..., cells, 6, 2, 3, 3]
    n_slots = cells * 12
    return tris.reshape(*lead, n_slots, 3, 3), valid.reshape(*lead, n_slots)


# ---- device: compact ------------------------------------------------------

def _pad_axis(f: torch.Tensor, axis: int, rows: int) -> torch.Tensor:
    """``f`` with ``rows`` planes of +1.0 appended along ``axis`` (never inf:
    inf-against-inf corners interpolate to NaN, which even a masked product
    carries)."""
    if rows == 0:
        return f
    shape = list(f.shape)
    shape[axis] = rows
    return torch.cat([f, f.new_ones(shape)], dim=axis)


def _live_prefix(items: torch.Tensor, valid: torch.Tensor, n: int):
    """The first ``n`` live slots of each lane, in slot order (the stable
    valid-first order the reference gets from an argsort): ``items [L, S,
    *item]``, ``valid [L, S]`` → ``(rows [L, n, *item], count [L, 1])``.
    Row j of lane l is the slot where the running count of live slots
    reaches (live slots before lane l) + j + 1: a searchsorted on one
    cumsum over all lanes (a 1-D scan; a scan along each of a few long rows
    is far slower on the H100), so only n rows a lane are gathered, however
    many slots are dead. Rows at or past ``count`` are other slots; callers
    mask them."""
    L, S = valid.shape
    csum = torch.cumsum(valid.reshape(-1), 0)
    last = csum[S - 1::S]                                    # live slots through lane l
    before = torch.cat([last.new_zeros(1), last[:-1]])
    want = before[:, None] + torch.arange(1, n + 1, device=valid.device)
    src = torch.searchsorted(csum, want).clamp_(max=L * S - 1)
    rows = items.reshape((L * S,) + items.shape[2:]).index_select(0, src.reshape(-1))
    return rows.reshape((L, n) + items.shape[2:]), (last - before)[:, None]


# Slots extracted in one pass of the compact extractors: several tiles at a
# time where they fit, so that a large field takes a few passes of large
# ops rather than one pass of small ops per tile (the host's launches set
# the time of small ones); ~2 GB of intermediates at 3-D's ~250 B a slot.
CHUNK_SLOTS = 1 << 23


def _tiled_compact(fpad: torch.Tensor, axis0: int, extract, n_cells_0: int, ti: int,
                   slots_per_plane: int, max_out: int, cap: int, item_shape):
    """Walk the field in tiles of ``ti`` cell-planes along ``axis0`` (the
    first axis after the lanes), run the slot extraction ``extract(blk,
    base) -> (items [..., slots, *item_shape], valid)`` and stream each
    tile's live slots, in slot order, into one ``max_out``-row buffer at a
    running offset, with the reference's arithmetic: per tile ``take =
    min(count, clip(max_out − offset, 0, cap))``, its first ``take`` live
    slots (`_live_prefix`) written at ``offset``, and the offset moved by
    ``take``. Since ``offset ≤ max_out``, the offset after tile t is
    ``min(offset_0 + Σ_{s≤t} min(count_s, cap), max_out)``, so a group of
    tiles is extracted in one pass (as many as fit in `CHUNK_SLOTS`; the
    slots of a group are its tiles' in order, bit for bit) and compacted
    without a loop over its tiles; a tile's rows past its take go to spare
    rows of their own. Offsets and counts stay on the device: the loop
    over groups reads nothing back. Pad-region cells (``fpad`` is padded so
    every tile slices ti+1 planes) are masked by their global plane index.

    Returns ``(items [..., max_out, *item_shape], count [...], overflowed
    [...])``: rows ``[:count]`` are live (zeros beyond); ``overflowed`` is
    True iff items were dropped against ``max_out`` or the per-tile
    ``cap``."""
    lead = fpad.shape[:axis0]
    L = int(np.prod(lead, dtype=np.int64))
    dev = fpad.device
    n_tiles = -(-n_cells_0 // ti)
    slots_tile = ti * slots_per_plane
    cap = min(cap, slots_tile)
    G = max(1, min(n_tiles, CHUNK_SLOTS // (L * slots_tile)))
    item_shape = tuple(item_shape)
    rows_lane = max_out + G * cap
    out = torch.zeros((L * rows_lane,) + item_shape, dtype=torch.float32, device=dev)
    j = torch.arange(cap, device=dev)
    spare = max_out + torch.arange(G, device=dev)[:, None] * cap + j        # [G, cap]
    lane0 = (torch.arange(L, device=dev) * rows_lane)[:, None, None]
    offset = torch.zeros((L, 1), dtype=torch.int64, device=dev)
    found = torch.zeros((L, 1), dtype=torch.int64, device=dev)
    for t0 in range(0, n_tiles, G):
        g = min(G, n_tiles - t0)
        items, valid = extract(fpad.narrow(axis0, t0 * ti, g * ti + 1), float(t0 * ti))
        valid = valid.reshape(L, g * slots_tile)
        live_planes = n_cells_0 - t0 * ti
        if live_planes < g * ti:
            valid = valid.clone()
            valid[:, live_planes * slots_per_plane:] = False
        rows, count = _live_prefix(items.reshape((L * g, slots_tile) + item_shape),
                                   valid.reshape(L * g, slots_tile), cap)
        count = count.reshape(L, g)
        ends = (offset + count.clamp(max=cap).cumsum(1)).clamp(max=max_out)
        starts = torch.cat([offset, ends[:, :-1]], 1)
        dest = torch.where(j < (ends - starts)[..., None], starts[..., None] + j, spare[:g])
        out.index_copy_(0, (dest + lane0).reshape(-1), rows.reshape((-1,) + item_shape))
        offset = ends[:, -1:]
        found = found + count.sum(1, keepdim=True)
    out = out.reshape((L, rows_lane) + item_shape)[:, :max_out]
    return (out.reshape(tuple(lead) + (max_out,) + item_shape),
            offset.reshape(lead), (found > offset).reshape(lead))


def marching_squares_device_compact(field: torch.Tensor, level: float = 0.0,
                                    max_segments: int | None = None,
                                    tile_rows: int = 64,
                                    tile_capacity: int | None = None):
    """Marching squares on the field's device with a bounded output.

    The fixed-slot `marching_squares_device` emits 2 slots per cell (~536
    MB at 4096²); this form streams row tiles through the same slot
    extraction and keeps only the live segments (`_tiled_compact`).

    field: [H, W], or [B, H, W] for B lanes in one call. Returns
    ``(segments [(B,) max_segments, 2, 2], count [(B,)] int64, overflowed
    [(B,)] bool)``: rows ``[:count]`` are the segments in the full-slot
    stream order (zeros beyond); ``overflowed`` is True iff segments were
    dropped because the count would pass ``max_segments`` or a tile cut
    more than ``tile_capacity`` slots.

    max_segments: output capacity; default ``8·max(H-1, W-1)`` (a contour
      in an N² grid has O(N) segments). tile_rows: cell-rows per tile.
      tile_capacity: per-tile cap; default two fully-cut cell rows.
    """
    f = _shifted(field, level)
    H, W = f.shape[-2:]
    if max_segments is None:
        max_segments = 8 * max(H - 1, W - 1)
    ti = max(1, min(tile_rows, H - 1))
    n_tiles = -(-(H - 1) // ti)
    fpad = _pad_axis(f, f.ndim - 2, n_tiles * ti + 1 - H)
    cap = (tile_capacity if tile_capacity is not None
           else 2 * 2 * (W - 1))
    return _tiled_compact(fpad, f.ndim - 2, _ms_slots, H - 1, ti, 2 * (W - 1),
                          max_segments, cap, (2, 2))


def marching_tetrahedra_device_compact(field: torch.Tensor, level: float = 0.0,
                                       max_triangles: int | None = None,
                                       tile_planes: int = 8,
                                       tile_capacity: int | None = None):
    """Marching tetrahedra on the field's device with a bounded output.

    `marching_tetrahedra_device` materializes 12 triangle slots per cell
    (~900 MB at 128³); this form walks the grid in tiles of
    ``tile_planes`` cell-planes along axis 0, runs the same slot
    extraction per tile and streams the live triangles into one capped
    buffer at a running offset (`_tiled_compact`), in the full-slot
    extractor's stream order (row-major cells, _TETS order).

    field: [NI, NJ, NK], or [B, NI, NJ, NK] for B lanes in one call.
    Returns ``(triangles [(B,) max_triangles, 3, 3], count [(B,)] int64,
    overflowed [(B,)] bool)``: rows ``[:count]`` are the triangles (zeros
    beyond); ``overflowed`` is True iff triangles were dropped against
    ``max_triangles`` or ``tile_capacity``.

    max_triangles: output capacity. Default ``48·(NJ-1)·(NK-1)`` (a closed
      surface in an N³ grid emits O(N²) triangles — ~4 full cut planes).
    tile_planes: cell-planes per tile (memory/throughput knob).
    tile_capacity: per-tile capacity. Default one fully-cut plane of
      cells, ``12·(NJ-1)·(NK-1)``.
    """
    f = _shifted(field, level)
    NI, NJ, NK = f.shape[-3:]
    cells_jk = (NJ - 1) * (NK - 1)
    if max_triangles is None:
        max_triangles = 48 * cells_jk
    ti = max(1, min(tile_planes, NI - 1))
    n_tiles = -(-(NI - 1) // ti)
    fpad = _pad_axis(f, f.ndim - 3, n_tiles * ti + 1 - NI)
    cap = (tile_capacity if tile_capacity is not None else 12 * cells_jk)
    return _tiled_compact(fpad, f.ndim - 3, _mt_slots, NI - 1, ti, 12 * cells_jk,
                          max_triangles, cap, (3, 3))
