"""Field → image helpers: counterpart of ``field_interpolation_tpu.visualize``
(the reference GUI's heatmap, contour and arrow rendering). Host-side
NumPy; fields, segments and positions may be torch tensors (copied to the
host). Returns uint8 RGB arrays; `write_ppm` saves one with no imaging
dependency."""

from __future__ import annotations

import numpy as np

from .contour import _host


def sdf_colormap(field, scale: float | None = None) -> np.ndarray:
    """Classic SDF heatmap: blue outside (positive), orange inside (negative),
    white at the surface, with distance banding. Returns [H, W, 3] uint8."""
    f = np.asarray(_host(field), dtype=np.float64)
    if scale is None:
        scale = max(1e-9, np.percentile(np.abs(f), 95))
    t = np.clip(f / scale, -1.0, 1.0)

    outside = np.array([90, 140, 255.0])
    inside = np.array([255, 150, 60.0])
    base = np.where(t[..., None] >= 0, outside, inside)
    # Fade toward white at the zero level set.
    fade = np.abs(t)[..., None]
    rgb = 255.0 * (1 - fade) + base * fade
    # Distance bands (every 0.1 of scale) like the reference demo's rings.
    bands = 0.5 + 0.5 * np.cos(np.abs(t) * 20 * np.pi)
    rgb *= (0.92 + 0.08 * bands[..., None])
    return np.clip(rgb, 0, 255).astype(np.uint8)


def value_colormap(field, vmin=None, vmax=None) -> np.ndarray:
    """Simple signed-value heatmap (blue→white→red diverging)."""
    f = np.asarray(_host(field), dtype=np.float64)
    vmin = np.min(f) if vmin is None else vmin
    vmax = np.max(f) if vmax is None else vmax
    mid = 0.5 * (vmin + vmax)
    half = max(1e-9, 0.5 * (vmax - vmin))
    t = np.clip((f - mid) / half, -1, 1)
    neg = np.array([60, 100, 255.0])
    pos = np.array([255, 70, 70.0])
    base = np.where(t[..., None] >= 0, pos, neg)
    rgb = 255.0 * (1 - np.abs(t)[..., None]) + base * np.abs(t)[..., None]
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _stamp(img: np.ndarray, a: np.ndarray, b: np.ndarray, color) -> None:
    """Stamp the pixels along segment a → b (lattice coords) that fall
    inside the image."""
    H, W = img.shape[:2]
    n = int(np.ceil(np.hypot(*(b - a)) * 4)) + 1
    for t in np.linspace(0.0, 1.0, n):
        p = a + t * (b - a)
        r, c = int(round(p[0])), int(round(p[1]))
        if 0 <= r < H and 0 <= c < W:
            img[r, c] = color


def draw_contour(image: np.ndarray, segments, color=(0, 0, 0)) -> np.ndarray:
    """Rasterize marching-squares segments onto an image (in lattice coords:
    segment endpoints are (row, col)). Simple line stamping."""
    img = image.copy()
    for a, b in np.asarray(_host(segments), np.float64):
        _stamp(img, a, b, color)
    return img


def draw_arrows(image: np.ndarray, positions, directions, length: float = 6.0,
                color=(0, 200, 0)) -> np.ndarray:
    """Rasterize direction arrows at lattice positions — the reference GUI's
    gradient/normal-arrow overlay. positions/directions are [n, 2] in (row,
    col) lattice coords; each arrow is a `length`-pixel shaft along the
    (normalized) direction plus two short head strokes."""
    img = image.copy()
    pos = np.asarray(_host(positions), np.float64)
    d = np.asarray(_host(directions), np.float64)
    norm = np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    d = d / norm
    # 30° head strokes, 40% of the shaft
    ca, sa = np.cos(np.pi * 5 / 6), np.sin(np.pi * 5 / 6)
    for p, u in zip(pos, d):
        tip = p + length * u
        _stamp(img, p, tip, color)
        left = np.array([ca * u[0] - sa * u[1], sa * u[0] + ca * u[1]])
        right = np.array([ca * u[0] + sa * u[1], -sa * u[0] + ca * u[1]])
        _stamp(img, tip, tip + 0.4 * length * left, color)
        _stamp(img, tip, tip + 0.4 * length * right, color)
    return img


def write_ppm(path: str, rgb: np.ndarray) -> None:
    """Save an RGB uint8 image as binary PPM (no imaging deps needed)."""
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes())
