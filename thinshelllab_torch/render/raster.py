"""The port's image path: what matplotlib's 3-D axes (Agg), PIL and imageio
do for the JAX package's render modules, written with torch, numpy and
zlib, so that rendering runs where none of those packages is installed.

- `Axes3DView`: the projection of matplotlib's 3-D axes for given limits
  and `view_init(elev, azim)` at matplotlib's defaults (perspective,
  focal length 1, camera distance 10, box aspect 4:4:3), the same matrix
  as `Axes3D.get_proj()`, and the axes' square box in the figure, so a
  point lands on the pixel where matplotlib would draw it.
- `fill_triangles` / `paint`: flat-coloured triangles in a given painter's
  order. Every pixel keeps the largest painter rank among the triangles
  whose interior holds its centre (a `scatter_reduce(..., "amax")` over
  each triangle's bounding-box pixels), which is the painter's-algorithm
  picture in one pass; it runs in torch on the triangles' device. No
  anti-aliasing: an edge pixel takes one triangle's colour.
- `draw_points` / `draw_segments` / `quiver_segments`: discs and one-pixel
  lines for the scatter and quiver plots.
- `write_png` / `read_png`: 8-bit RGB PNG files. `write_gif` /
  `read_gif`: a GIF89a of frames on one global palette (exact when the
  frames hold at most 256 colours, else a 6x6x6 colour cube), LZW-coded,
  with a frame delay in hundredths of a second.
"""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

# matplotlib's defaults: the subplot box (left, bottom, width, height) in
# figure fractions, the camera distance, the box aspect 4:4:3 with its
# scale (Axes3D.set_box_aspect), the 2-D view limits of the projected
# plane (Axes3D.set_top_view) and the view margin of autoscaled limits
_SUBPLOT = (0.125, 0.11, 0.775, 0.77)
_DIST = 10.0
_BOX = np.asarray((4.0, 4.0, 3.0))
_BOX = _BOX * (1.8294640721620434 * 25 / 24 / np.linalg.norm(_BOX))
_VIEW_LIM = (-0.95 / _DIST, 0.9 / _DIST)
_VIEW_MARGIN = 1 / 48
_AXES_MARGIN = 0.05

# matplotlib's first colour cycle entry ('C0') and the scatter marker's
# radius in pixels at 100 dpi (markersize 6 pt)
C0 = (31, 119, 180)
RED = (255, 0, 0)
MARKER_RADIUS = 3.0 * 100 / 72


def axes3d_proj(lims, elev=20.0, azim=-60.0) -> np.ndarray:
    """(4, 4) float64: matplotlib's `Axes3D.get_proj()` for the limits
    ((x0, x1), (y0, y1), (z0, z1)) and `view_init(elev, azim)` (roll 0,
    z vertical, perspective with focal length 1)."""
    (x0, x1), (y0, y1), (z0, z1) = lims
    dx, dy, dz = (x1 - x0) / _BOX[0], (y1 - y0) / _BOX[1], (z1 - z0) / _BOX[2]
    world = np.array([[1 / dx, 0, 0, -x0 / dx],
                      [0, 1 / dy, 0, -y0 / dy],
                      [0, 0, 1 / dz, -z0 / dz],
                      [0, 0, 0, 1]])
    R = 0.5 * _BOX
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    ps = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    eye = R + _DIST * ps
    w = (eye - R) / np.linalg.norm(eye - R)
    u = np.cross(np.array([0.0, 0.0, 1.0]), w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    rot = np.eye(4)
    rot[:3, :3] = [u, v, w]
    shift = np.eye(4)
    shift[:3, -1] = -eye
    view = np.dot(rot, shift)
    zf, zb = -_DIST, _DIST
    persp = np.array([[1.0, 0, 0, 0],
                      [0, 1.0, 0, 0],
                      [0, 0, (zf + zb) / (zf - zb), -2 * (zf * zb) / (zf - zb)],
                      [0, 0, -1, 0]])
    return np.dot(persp, np.dot(view, world))


def auto_lims(points, fixed=None):
    """matplotlib's autoscaled 3-D limits of an (N, 3) point set: the data
    range widened by the axes margin and then the view margin (a flat
    range becomes +-1e-3 around it); `fixed` maps an axis index to
    limits that are kept as given."""
    p = np.asarray(points, np.float64).reshape(-1, 3)
    out = []
    for d in range(3):
        if fixed and d in fixed:
            out.append(tuple(float(v) for v in fixed[d]))
            continue
        lo, hi = (float(p[:, d].min()), float(p[:, d].max())) if len(p) \
            else (-0.05, 0.05)
        if hi - lo < 1e-12:
            lo, hi = lo - 1e-3, hi + 1e-3
        pad = (hi - lo) * _AXES_MARGIN
        lo, hi = lo - pad, hi + pad
        pad = (hi - lo) * _VIEW_MARGIN
        out.append((lo - pad, hi + pad))
    return tuple(out)


class Axes3DView:
    """One matplotlib 3-D axes in a figure of width x height pixels at its
    default subplot position, made square as `Axes3D.apply_aspect` does.
    Image coordinates: x to the right, y down, pixel (r, c) centred at
    (c + 0.5, r + 0.5)."""

    def __init__(self, lims, elev=20.0, azim=-60.0, width=600, height=600):
        self.M = axes3d_proj(lims, elev, azim)
        self.width, self.height = width, height
        left, bottom, w, h = _SUBPLOT
        fig_aspect = height / width
        sq_h = w / fig_aspect
        sq_w, sq_h = (w, sq_h) if sq_h <= h else (h * fig_aspect, h)
        x0 = left + (w - sq_w) / 2
        y0 = bottom + (h - sq_h) / 2
        # the axes box in image coordinates (x0, y0, x1, y1)
        self.box = (x0 * width, (1 - y0 - sq_h) * height,
                    (x0 + sq_w) * width, (1 - y0) * height)

    def project(self, pts):
        """(N, 3) tensor -> (xs, ys, zs): matplotlib's
        `proj3d.proj_transform(x, y, z, M)` (the projected plane)."""
        M = torch.as_tensor(self.M, dtype=torch.float64, device=pts.device)
        p = pts.to(torch.float64)
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        r = [M[i, 0] * x + M[i, 1] * y + M[i, 2] * z + M[i, 3]
             for i in range(4)]
        return r[0] / r[3], r[1] / r[3], r[2] / r[3]

    def to_pixels(self, pts):
        """(N, 3) tensor -> (N, 2) float64 image coordinates."""
        xs, ys, _ = self.project(pts)
        (lo, hi), (bx0, by0, bx1, by1) = _VIEW_LIM, self.box
        px = bx0 + (xs - lo) / (hi - lo) * (bx1 - bx0)
        py = by1 - (ys - lo) / (hi - lo) * (by1 - by0)
        return torch.stack([px, py], dim=-1)


def fill_triangles(tri, height, width, box=None, chunk=1 << 21):
    """(height, width) int64 painter-rank map of the triangles `tri`
    (F, 3, 2) in image coordinates: each pixel holds the largest index f
    whose triangle holds the pixel's centre (edges included), -1 where
    none does. Later triangles are painted over earlier ones. `box`
    (x0, y0, x1, y1) clips to the pixels whose centres lie inside it.
    Runs on tri's device; `chunk` bounds the candidate pixels in flight."""
    dev = tri.device
    t = tri.to(torch.float64)
    out = torch.full((height * width,), -1, dtype=torch.int64, device=dev)
    if t.shape[0] == 0:
        return out.view(height, width)
    bx0, by0, bx1, by1 = box or (0.0, 0.0, float(width), float(height))
    lo, hi = t.amin(dim=1), t.amax(dim=1)
    c0 = torch.clamp(torch.ceil(lo[:, 0] - 0.5), min=max(math.ceil(bx0 - 0.5), 0))
    c1 = torch.clamp(torch.floor(hi[:, 0] - 0.5),
                     max=min(math.floor(bx1 - 0.5), width - 1))
    r0 = torch.clamp(torch.ceil(lo[:, 1] - 0.5), min=max(math.ceil(by0 - 0.5), 0))
    r1 = torch.clamp(torch.floor(hi[:, 1] - 0.5),
                     max=min(math.floor(by1 - 0.5), height - 1))
    a, b, c = t[:, 0], t[:, 1], t[:, 2]
    area = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
            - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
    ok = torch.isfinite(area) & (area != 0)
    bw = torch.where(ok, torch.clamp(c1 - c0 + 1, min=0), torch.zeros_like(c0))
    bh = torch.where(ok, torch.clamp(r1 - r0 + 1, min=0), torch.zeros_like(r0))
    counts = (bw * bh).to(torch.int64)
    bw, c0, r0 = bw.to(torch.int64), c0.to(torch.int64), r0.to(torch.int64)
    ends = torch.cumsum(counts, 0).cpu().numpy()
    first, F = 0, t.shape[0]
    while first < F:
        base = ends[first - 1] if first else 0
        last = int(np.searchsorted(ends, base + chunk, side="right"))
        last = min(max(last, first + 1), F)
        ids = torch.repeat_interleave(
            torch.arange(first, last, device=dev), counts[first:last])
        if ids.numel():
            start = torch.cumsum(counts[first:last], 0) - counts[first:last]
            k = torch.arange(ids.numel(), device=dev) - start[ids - first]
            col = c0[ids] + k % bw[ids]
            row = r0[ids] + torch.div(k, bw[ids], rounding_mode="floor")
            cx, cy = col.to(torch.float64) + 0.5, row.to(torch.float64) + 0.5
            tt = t[ids]
            e = [(tt[:, j1, 0] - tt[:, j0, 0]) * (cy - tt[:, j0, 1])
                 - (tt[:, j1, 1] - tt[:, j0, 1]) * (cx - tt[:, j0, 0])
                 for j0, j1 in ((0, 1), (1, 2), (2, 0))]
            inside = (((e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0))
                      | ((e[0] <= 0) & (e[1] <= 0) & (e[2] <= 0)))
            out.scatter_reduce_(0, (row * width + col)[inside], ids[inside],
                                "amax", include_self=True)
        first = last
    return out.view(height, width)


def paint(rank, colors, background=(255, 255, 255)):
    """(H, W, 3) uint8 image of a painter-rank map: pixel = colors[rank]
    ((F, 3) uint8) where rank >= 0, else the background."""
    colors = torch.as_tensor(colors, dtype=torch.uint8, device=rank.device)
    bg = torch.tensor(background, dtype=torch.uint8, device=rank.device)
    img = colors[torch.clamp(rank, min=0)]
    return torch.where((rank >= 0)[..., None], img, bg)


def to_uint8(colors):
    """Float colours in [0, 1] -> uint8, rounded to nearest."""
    return np.floor(np.clip(np.asarray(colors, np.float64), 0.0, 1.0) * 255
                    + 0.5).astype(np.uint8)


def _put(img, rows, cols, color, box):
    x0, y0, x1, y1 = box
    keep = ((cols + 0.5 >= x0) & (cols + 0.5 <= x1) & (rows + 0.5 >= y0)
            & (rows + 0.5 <= y1) & (rows >= 0) & (cols >= 0)
            & (rows < img.shape[0]) & (cols < img.shape[1]))
    img[rows[keep], cols[keep]] = torch.tensor(color, dtype=torch.uint8,
                                               device=img.device)


def draw_points(img, xy, color=C0, radius=MARKER_RADIUS, box=None):
    """Filled discs of `radius` pixels at the (N, 2) image points xy, in
    place on img (H, W, 3) uint8; returns img."""
    box = box or (0.0, 0.0, img.shape[1], img.shape[0])
    xy = xy[torch.isfinite(xy).all(dim=1)]
    r = int(math.ceil(radius))
    d = torch.arange(-r, r + 1, device=img.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    rows = torch.floor(xy[:, 1])[:, None, None].long() + dy
    cols = torch.floor(xy[:, 0])[:, None, None].long() + dx
    dist2 = ((cols + 0.5 - xy[:, 0, None, None]) ** 2
             + (rows + 0.5 - xy[:, 1, None, None]) ** 2)
    m = dist2 <= radius * radius
    _put(img, rows[m], cols[m], color, box)
    return img


def draw_segments(img, p0, p1, color=C0, box=None):
    """One-pixel lines from the (N, 2) image points p0 to p1, in place on
    img (H, W, 3) uint8; returns img."""
    box = box or (0.0, 0.0, img.shape[1], img.shape[0])
    ok = torch.isfinite(p0).all(dim=1) & torch.isfinite(p1).all(dim=1)
    p0, p1 = p0[ok], p1[ok]
    if p0.shape[0] == 0:
        return img
    n = int(torch.ceil((p1 - p0).abs().amax()).item()) + 1
    s = torch.linspace(0.0, 1.0, n + 1, dtype=p0.dtype, device=img.device)
    pts = p0[:, None, :] + s[None, :, None] * (p1 - p0)[:, None, :]
    _put(img, torch.floor(pts[..., 1]).long().reshape(-1),
         torch.floor(pts[..., 0]).long().reshape(-1), color, box)
    return img


def quiver_segments(xyz, uvw, length=1.0, normalize=False,
                    arrow_length_ratio=0.3):
    """The 3-D segments of matplotlib's `Axes3D.quiver` (pivot 'tail'): a
    shaft from each point back along its vector and two head strokes at
    the point, each turned 15 degrees off the shaft. Returns (starts,
    ends), both (3N, 3) float64 numpy."""
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    uvw = np.asarray(uvw, np.float64).reshape(-1, 3)
    if normalize:
        norm = np.linalg.norm(uvw, axis=1, keepdims=True)
        uvw = np.divide(uvw, norm, where=norm != 0, out=np.zeros_like(uvw))
    x, y = uvw[:, 0], uvw[:, 1]
    n2 = np.linalg.norm(uvw[:, :2], axis=1)
    xp = np.divide(y, n2, where=n2 != 0, out=np.zeros_like(x))
    yp = np.divide(-x, n2, where=n2 != 0, out=np.ones_like(x))
    c, s = math.cos(math.radians(15)), math.sin(math.radians(15))
    rpos = np.array([[c + xp**2 * (1 - c), xp * yp * (1 - c), yp * s],
                     [xp * yp * (1 - c), c + yp**2 * (1 - c), -xp * s],
                     [-yp * s, xp * s, np.full_like(xp, c)]])
    rneg = rpos.copy()
    rneg[[0, 1, 2, 2], [2, 2, 0, 1]] *= -1
    heads = [np.einsum("ij...,...j->...i", r, uvw) for r in (rpos, rneg)]
    starts = np.concatenate([xyz, xyz, xyz])
    ends = np.concatenate([xyz - length * uvw]
                          + [xyz - arrow_length_ratio * length * h
                             for h in heads])
    return starts, ends


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------


def _chunk(kind, data):
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path, img):
    """An 8-bit RGB PNG of img (H, W, 3) uint8 (numpy or tensor)."""
    img = np.ascontiguousarray(
        img.cpu().numpy() if isinstance(img, torch.Tensor) else img,
        dtype=np.uint8)
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
    return path


def read_png(path):
    """(H, W, 3) uint8 of an 8-bit RGB, non-interlaced PNG whose rows all
    use filter 0, as write_png writes them; anything else raises."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}; read_png reads 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows; read_png reads filter 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


# --------------------------------------------------------------------------
# GIF
# --------------------------------------------------------------------------


def _palette(frames):
    """(palette (P, 3) uint8 with P a power of two >= 2, per-frame index
    arrays): the frames' own colours when they hold <= 256, else the
    6x6x6 colour cube."""
    packed = [(f[..., 0].astype(np.int32) << 16) | (f[..., 1].astype(np.int32) << 8)
              | f[..., 2].astype(np.int32) for f in frames]
    colours = np.unique(np.concatenate([p.ravel() for p in packed]))
    if len(colours) <= 256:
        pal = np.stack([colours >> 16, (colours >> 8) & 255, colours & 255],
                       axis=1).astype(np.uint8)
        idx = [np.searchsorted(colours, p).astype(np.uint8) for p in packed]
    else:
        lv = np.arange(6) * 51
        pal = np.stack(np.meshgrid(lv, lv, lv, indexing="ij"),
                       axis=-1).reshape(-1, 3).astype(np.uint8)
        idx = [(np.floor(f.astype(np.float64) / 51 + 0.5).astype(np.int32)
                @ np.array([36, 6, 1])).astype(np.uint8) for f in frames]
    size = max(2, 1 << (len(pal) - 1).bit_length())
    pal = np.concatenate([pal, np.zeros((size - len(pal), 3), np.uint8)])
    return pal, idx


def _lzw_encode(indices, min_size):
    """GIF LZW code stream of a byte sequence (codes packed LSB first)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nacc = 0
    size, nxt, table = min_size + 1, eoi + 1, {}

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    emit(clear)
    it = iter(indices)
    prefix = next(it)
    for k in it:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear)
            size, nxt, table = min_size + 1, eoi + 1, {}
        prefix = k
    emit(prefix)
    emit(eoi)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _lzw_decode(data, min_size, n):
    """The first n indices of a GIF LZW code stream."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nacc = pos = 0
    size, table, prev = min_size + 1, None, None
    while len(out) < n:
        while nacc < size:
            if pos >= len(data):
                raise ValueError("GIF: the code stream ends early")
            acc |= data[pos] << nacc
            pos += 1
            nacc += 8
        code = acc & ((1 << size) - 1)
        acc >>= size
        nacc -= size
        if code == clear:
            size = min_size + 1
            table = [bytes([i]) for i in range(clear)] + [b"", b""]
            prev = None
            continue
        if code == eoi:
            break
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        out += entry
        prev = entry
        if len(table) == (1 << size) and size < 12:
            size += 1
    return np.frombuffer(bytes(out[:n]), np.uint8)


def write_gif(path, frames, duration=0.02):
    """A GIF89a of frames (each (H, W, 3) uint8, one size) on one global
    palette, every frame shown `duration` seconds (its delay in
    hundredths of a second, rounded)."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    h, w, _ = frames[0].shape
    pal, idx = _palette(frames)
    bits = len(pal).bit_length() - 1
    min_size = max(2, bits)
    delay = int(round(duration * 100))
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x80 | 0x70 | (bits - 1),
                                    0, 0), pal.tobytes()]
    for ix in idx:
        code = _lzw_encode(ix.tobytes(), min_size)
        parts += [b"\x21\xf9\x04\x00", struct.pack("<H", delay), b"\x00\x00",
                  b"\x2c", struct.pack("<HHHHB", 0, 0, w, h, 0),
                  bytes([min_size])]
        parts += [bytes([len(code[i:i + 255])]) + code[i:i + 255]
                  for i in range(0, len(code), 255)]
        parts.append(b"\x00")
    parts.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(parts))
    return path


def read_gif(path):
    """(frames, delays): the (H, W, 3) uint8 frames of a GIF whose frames
    fill the screen, are not interlaced and use the global palette (as
    write_gif writes them), and each frame's delay in hundredths of a
    second; anything else raises."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF file")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    if not flags & 0x80:
        raise ValueError(f"{path}: no global palette")
    n_pal = 2 << (flags & 7)
    pal = np.frombuffer(data[13:13 + 3 * n_pal], np.uint8).reshape(-1, 3)
    pos, frames, delays, delay = 13 + 3 * n_pal, [], [], 0
    while pos < len(data):
        kind = data[pos]
        if kind == 0x3B:
            break
        if kind == 0x21:
            label, pos = data[pos + 1], pos + 2
            if label == 0xF9:
                delay = struct.unpack("<H", data[pos + 2:pos + 4])[0]
            while data[pos]:
                pos += data[pos] + 1
            pos += 1
        elif kind == 0x2C:
            x, y, fw, fh, fl = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            if (x, y, fw, fh) != (0, 0, w, h) or fl & 0xC0:
                raise ValueError(f"{path}: a frame is not full-screen on the "
                                 "global palette or is interlaced")
            min_size, pos = data[pos + 10], pos + 11
            code = bytearray()
            while data[pos]:
                code += data[pos + 1:pos + 1 + data[pos]]
                pos += data[pos] + 1
            pos += 1
            ix = _lzw_decode(bytes(code), min_size, w * h)
            frames.append(pal[ix].reshape(h, w, 3))
            delays.append(delay)
        else:
            raise ValueError(f"{path}: unknown block 0x{kind:02x}")
    return frames, delays
