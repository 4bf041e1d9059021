"""Figures without matplotlib: the one drawing layer of the port's plots
(``pipeline.plots``, ``eval.metrics.save_error_histogram``).

A ``Figure`` is a record: a grid of ``Axes``, each holding its series
(2D or 3D polylines and markers, bars, text) with their data arrays,
colours and labels, a title, axis labels, limits (a y axis inverted by
limits given high to low), ``elev``/``azim`` for 3D (matplotlib's 30/-60
by default) and a dark style. The drawing calls mirror matplotlib's
(``plot``, ``scatter``, ``hist``, ``set_xlim``, ``view_init``, ...), so
a plot reads as its matplotlib twin does, and the series keep what a
test compares against matplotlib's artists.

``Figure.save(path)`` writes by the extension:

- ``.svg``: polylines, circles, rects and ``<text>``; the data
  polylines carry ``class="series"``;
- ``.pdf``: one page of ``m``/``l``/``S``/``re``/``f`` paths (markers as
  Bezier ``c`` circles) and ``BT ... Tj ET`` text in the base-14
  ``/Helvetica``, so no font is embedded;
- ``.png``: a numpy rasteriser (DDA lines, filled discs and rects, 3D
  data projected orthographically at ``elev``/``azim``; ``antialias``
  renders at twice the size and averages). It draws no glyphs: the
  titles, axis labels, legends and texts go into ``tEXt`` chunks
  (``utils.png.read_png_text``), and so do bars' edges and heights.

Any other extension raises, naming it.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .png import write_png

#: matplotlib's default colour cycle, and its dark_background style's
CYCLE = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2",
         "#7f7f7f", "#bcbd22", "#17becf")
DARK_CYCLE = ("#8dd3c7", "#feffb3", "#bfbbd9", "#fa8174", "#81b1d2", "#fdb462", "#b3de69",
              "#bc82bd", "#ccebc4", "#ffed6f")
#: the single-letter colours of a format string ("b-")
LETTER_COLOURS = {"b": "#0000ff", "g": "#008000", "r": "#ff0000", "c": "#00bfbf",
                  "m": "#bf00bf", "y": "#bfbf00", "k": "#000000", "w": "#ffffff"}
#: matplotlib's "tab:" names of its default cycle's colours
TAB_COLOURS = dict(zip(("tab:blue", "tab:orange", "tab:green", "tab:red", "tab:purple",
                        "tab:brown", "tab:pink", "tab:gray", "tab:olive", "tab:cyan"), CYCLE))
#: the markers drawn: a point, a disc, a square
MARKERS = ".os"
#: matplotlib's box aspect of a 3D axes
BOX_ASPECT = (4.0, 4.0, 3.0)
WRITERS = (".svg", ".pdf", ".png")


@dataclass
class Series:
    """One artist's data and style. ``kind`` is "line", "scatter",
    "bar" or "text"; ``data`` is (x, y) or (x, y, z) for lines, markers
    and texts, (left, height, width) for bars."""

    kind: str
    data: Tuple[np.ndarray, ...]
    color: str
    label: Optional[str] = None
    linewidth: float = 1.5  # points
    linestyle: str = "-"  # "-" or "" (markers only)
    marker: Optional[str] = None
    size: float = 36.0  # a scatter's marker area (points^2), a line's marker size (points)
    alpha: float = 1.0
    text: str = ""


def _parse_fmt(fmt):
    """matplotlib's "[colour][marker][line]" format string -> (colour,
    marker, linestyle)."""
    colour = marker = None
    line = ""
    for ch in fmt:
        if ch in LETTER_COLOURS:
            colour = LETTER_COLOURS[ch]
        elif ch in MARKERS:
            marker = ch
        elif ch == "-":
            line = "-"
        else:
            raise ValueError(f"format string {fmt!r}: {ch!r} is not a colour, marker or '-'")
    if marker is None and not line:
        line = "-"
    return colour, marker, line


def _colour(c):
    """A colour argument as "#rrggbb" (None stays None)."""
    if c is None or (isinstance(c, str) and c.startswith("#") and len(c) == 7):
        return c
    if c in TAB_COLOURS:
        return TAB_COLOURS[c]
    raise ValueError(f"colour {c!r}: '#rrggbb' or one of {', '.join(TAB_COLOURS)}")


def _finite(*arrays):
    ok = np.ones(np.shape(arrays[0]), bool)
    for a in arrays:
        ok &= np.isfinite(a)
    return ok


class Axes:
    """One panel: 2D, or 3D with ``projection="3d"``."""

    def __init__(self, projection=None, dark=False):
        if projection not in (None, "3d"):
            raise ValueError(f"projection {projection!r}: None or '3d'")
        self.projection = projection
        self.dark = dark
        self.series: List[Series] = []
        self.title = self.xlabel = self.ylabel = self.zlabel = ""
        self.limits = {"x": None, "y": None, "z": None}
        self.elev, self.azim = 30.0, -60.0
        self.visible = True
        self.show_legend = False
        self._n_lines = self._n_fills = 0

    # ---- the matplotlib-like calls ----

    def _next(self, which):
        cycle = DARK_CYCLE if self.dark else CYCLE
        if which == "line":
            self._n_lines += 1
            return cycle[(self._n_lines - 1) % len(cycle)]
        self._n_fills += 1
        return cycle[(self._n_fills - 1) % len(cycle)]

    def plot(self, *args, label=None, lw=1.5, ms=6.0, alpha=1.0, c=None):
        """plot(y), plot(x, y[, z][, fmt]): one line series; NaN breaks it.
        ``c`` (a "#rrggbb" or "tab:" colour) takes no colour of the cycle."""
        fmt = args[-1] if args and isinstance(args[-1], str) else None
        arrays = [np.asarray(a, dtype=np.float64).reshape(-1) for a in
                  (args[:-1] if fmt is not None else args)]
        dims = 3 if self.projection == "3d" else 2
        if len(arrays) == 1 and dims == 2:
            arrays = [np.arange(arrays[0].shape[0], dtype=np.float64)] + arrays
        if len(arrays) != dims:
            raise ValueError(f"plot on a {dims}D axes takes {dims} coordinate arrays, "
                             f"got {len(arrays)}")
        fcol, marker, line = _parse_fmt(fmt) if fmt else (None, None, "-")
        s = Series("line", tuple(arrays), _colour(c) or fcol or self._next("line"), label,
                   linewidth=lw, linestyle=line, marker=marker, size=ms, alpha=alpha)
        self.series.append(s)
        return s

    def scatter(self, *xyz, s=20.0, marker="o", label=None, alpha=1.0, c=None):
        """Markers at the points where every coordinate is finite (the
        others are dropped, as matplotlib's scatter drops them); ``c`` as
        for ``plot``."""
        arrays = [np.asarray(a, dtype=np.float64).reshape(-1) for a in xyz]
        ok = _finite(*arrays)
        arrays = tuple(a[ok] for a in arrays)
        series = Series("scatter", arrays, _colour(c) or self._next("fill"), label, marker=marker,
                        size=float(s), alpha=alpha)
        self.series.append(series)
        return series

    def bar(self, left, height, width):
        """Bars from ``left`` (their left edges) of ``width``, from 0 to
        ``height``."""
        data = tuple(np.asarray(a, dtype=np.float64).reshape(-1) for a in (left, height, width))
        series = Series("bar", data, self._next("fill"))
        self.series.append(series)
        return series

    def hist(self, values, bins=10):
        """``np.histogram``'s counts as bars over its edges, which is what
        matplotlib's ``hist`` draws. Returns (counts, edges)."""
        counts, edges = np.histogram(np.asarray(values), bins=bins)
        self.bar(edges[:-1], counts, np.diff(edges))
        return counts, edges

    def text(self, *xyz_s):
        """text(x, y[, z], s)."""
        *xyz, s = xyz_s
        data = tuple(np.asarray([float(v)]) for v in xyz)
        series = Series("text", data, "#ffffff" if self.dark else "#000000", text=s)
        self.series.append(series)
        return series

    def set_title(self, s, **_kw):
        self.title = str(s)

    def set_xlabel(self, s):
        self.xlabel = str(s)

    def set_ylabel(self, s):
        self.ylabel = str(s)

    def set_zlabel(self, s):
        self.zlabel = str(s)

    def set_xlim(self, lo, hi):
        self.limits["x"] = (float(lo), float(hi))

    def set_ylim(self, lo, hi):
        self.limits["y"] = (float(lo), float(hi))

    def set_zlim(self, lo, hi):
        self.limits["z"] = (float(lo), float(hi))

    def view_init(self, elev=30.0, azim=-60.0):
        self.elev, self.azim = float(elev), float(azim)

    def axis(self, state):
        if state != "off":
            raise ValueError(f"axis({state!r}): only 'off' is drawn")
        self.visible = False

    def legend(self, **_kw):
        self.show_legend = True

    # ---- what a test compares ----

    @property
    def lines(self):
        return [s for s in self.series if s.kind == "line"]

    @property
    def patches(self):
        return [s for s in self.series if s.kind == "bar"]

    @property
    def texts(self):
        return [s for s in self.series if s.kind == "text"]

    def get_xlim(self):
        return self._lim("x")

    def get_ylim(self):
        return self._lim("y")

    def get_zlim(self):
        return self._lim("z")

    def _lim(self, axis):
        """The limits given, else the data's with 5% margins (matplotlib's
        ``axes.xmargin``), bars' bottoms held at 0 (their sticky edge)."""
        if self.limits[axis] is not None:
            return self.limits[axis]
        i = "xyz".index(axis)
        vals, sticky = [], []
        for s in self.series:
            if s.kind == "bar":
                left, height, width = s.data
                if axis == "x":
                    vals += [left, left + width]
                else:
                    vals += [np.zeros(1), height]
                    sticky.append(np.zeros(1))
            elif i < len(s.data):
                vals.append(s.data[i])
        v = np.concatenate(vals) if vals else np.zeros(0)
        v = v[np.isfinite(v)]
        if v.size == 0:
            return (0.0, 1.0)
        lo, hi = float(v.min()), float(v.max())
        if hi - lo <= 1e-12 * max(abs(lo), abs(hi)):
            lo, hi = (lo - 0.05 * abs(lo), hi + 0.05 * abs(hi)) if lo or hi else (-0.05, 0.05)
        pad = 0.05 * (hi - lo)
        st = np.concatenate(sticky) if sticky else np.zeros(0)
        lo2 = lo if np.any(st == lo) else lo - pad
        hi2 = hi if np.any(st == hi) else hi + pad
        return (lo2, hi2)


class Figure:
    """A grid of axes, ``figsize`` inches, written by ``save``."""

    def __init__(self, nrows=1, ncols=1, figsize=(6.4, 4.8), dpi=100, dark=False,
                 projection=None):
        self.nrows, self.ncols = int(nrows), int(ncols)
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.dpi = dpi
        self.dark = dark
        self.axes = [[Axes(projection, dark) for _ in range(self.ncols)]
                     for _ in range(self.nrows)]

    @property
    def flat(self):
        return [ax for row in self.axes for ax in row]

    def save(self, path, antialias=False):
        ext = os.path.splitext(str(path))[1].lower()
        if ext not in WRITERS:
            raise ValueError(f"{path}: no figure writer for {ext or 'a name without an '}"
                             f"extension; {', '.join(WRITERS)}")
        os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
        if ext == ".svg":
            with open(path, "w", encoding="utf-8") as f:
                f.write(self.to_svg())
        elif ext == ".pdf":
            with open(path, "wb") as f:
                f.write(self.to_pdf())
        else:
            img, text = self.to_png(antialias)
            write_png(path, img, text=text)
        return path

    def to_svg(self) -> str:
        return _svg(self, _display_list(self))

    def to_pdf(self) -> bytes:
        return _pdf(self, _display_list(self))

    def to_png(self, antialias=False):
        """(uint8 (H, W, 3) image, [(keyword, text)]) at ``dpi``."""
        return _raster(self, _display_list(self), 2 if antialias else 1), _png_text(self)


def subplots(nrows=1, ncols=1, **kw):
    """(figure, axes) as matplotlib's ``plt.subplots(..., squeeze=False)``
    gives them: axes a list of rows."""
    fig = Figure(nrows, ncols, **kw)
    return fig, fig.axes


# --------------------------------------------------------------------------
# Layout: every axes as primitives in points (1/72 inch), y down
# --------------------------------------------------------------------------


@dataclass
class Prim:
    """A drawing primitive. kind: "poly" (pts (K, 2)), "marks" (centres
    (M, 2), size = radius, shape "o" or "s"), "rect" (pts = [[x, y],
    [w, h]], filled by ``color``, edged by ``edge``), "text" (pts [[x,
    y]], ``text``, size = font size, ``anchor``). ``clip`` (x, y, w, h)
    bounds what is drawn."""

    kind: str
    pts: np.ndarray
    color: str
    width: float = 1.0
    alpha: float = 1.0
    size: float = 0.0
    shape: str = "o"
    text: str = ""
    anchor: str = "start"
    cls: str = "axis"
    clip: Optional[Tuple[float, float, float, float]] = None
    edge: Optional[str] = None


def _colours(fig):
    return ("#000000", "#ffffff") if fig.dark else ("#ffffff", "#000000")


def _nice_ticks(lo, hi, n=5):
    a, b = min(lo, hi), max(lo, hi)
    span = b - a
    if not span > 0:
        return np.array([a])
    raw = span / n
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    t = np.arange(math.ceil(a / step) * step, b + 1e-9 * span, step)
    return t[(t >= a - 1e-9 * span) & (t <= b + 1e-9 * span)]


def _split_finite(pts):
    """The runs of consecutive finite rows of pts (K, 2)."""
    ok = np.isfinite(pts).all(axis=1)
    runs, start = [], None
    for i, good in enumerate(np.append(ok, False)):
        if good and start is None:
            start = i
        elif not good and start is not None:
            runs.append(pts[start:i])
            start = None
    return runs


def _series_prims(s, to_xy, clip, out):
    """The primitives of one series, ``to_xy`` mapping its data arrays to
    points (K, 2)."""
    if s.kind == "line":
        xy = to_xy(*s.data)
        if s.linestyle:
            for run in _split_finite(xy):
                out.append(Prim("poly", run, s.color, s.linewidth, s.alpha, cls="series",
                                clip=clip))
        if s.marker:
            pts = xy[np.isfinite(xy).all(axis=1)]
            r = s.size / 4.0 if s.marker in ".," else s.size / 2.0
            out.append(Prim("marks", pts, s.color, alpha=s.alpha, size=r,
                            shape="s" if s.marker == "s" else "o", cls="marker", clip=clip))
    elif s.kind == "scatter":
        out.append(Prim("marks", to_xy(*s.data), s.color, alpha=s.alpha,
                        size=math.sqrt(s.size) / 2.0, shape="s" if s.marker == "s" else "o",
                        cls="marker", clip=clip))
    elif s.kind == "bar":
        left, height, width = s.data
        a = to_xy(left, np.zeros_like(left))
        b = to_xy(left + width, height)
        for (x0, y0), (x1, y1) in zip(a, b):
            out.append(Prim("rect", np.array([[min(x0, x1), min(y0, y1)],
                                              [abs(x1 - x0), abs(y1 - y0)]]),
                            s.color, alpha=s.alpha, cls="bar", clip=clip))
    else:
        out.append(Prim("text", to_xy(*s.data), s.color, size=8.0, text=s.text, cls="label",
                        clip=clip))


def _legend_prims(ax, right, top, fg, bg, out):
    entries = [s for s in ax.series if s.label and not s.label.startswith("_")]
    if not entries:
        return
    h = 11.0
    w = 30.0 + 5.0 * max(len(s.label) for s in entries)
    x0, y0 = right - w - 6, top + 6
    out.append(Prim("rect", np.array([[x0, y0], [w, h * len(entries) + 6]]), bg, alpha=0.8,
                    edge=fg, cls="legend"))
    for i, s in enumerate(entries):
        y = y0 + 3 + h * (i + 0.5)
        if s.kind == "line":
            out.append(Prim("poly", np.array([[x0 + 4, y], [x0 + 20, y]]), s.color,
                            s.linewidth, cls="legend"))
        else:
            out.append(Prim("marks", np.array([[x0 + 12, y]]), s.color, size=3.0,
                            shape="s" if s.marker == "s" else "o", cls="legend"))
        out.append(Prim("text", np.array([[x0 + 24, y + 3]]), fg, size=8.0, text=s.label,
                        cls="legend"))


def _axes_2d(ax, rect, fg, bg, out):
    x, y, w, h = rect
    (x0, x1), (y0, y1) = ax.get_xlim(), ax.get_ylim()

    def to_xy(xs, ys):
        return np.stack([x + (np.asarray(xs) - x0) / (x1 - x0) * w,
                         y + h - (np.asarray(ys) - y0) / (y1 - y0) * h], axis=-1)

    for s in ax.series:
        _series_prims(s, to_xy, rect, out)
    out.append(Prim("rect", np.array([[x, y], [w, h]]), "none", edge=fg, width=0.8))
    for t in _nice_ticks(x0, x1):
        px = to_xy([t], [y0])[0, 0]
        out.append(Prim("poly", np.array([[px, y + h], [px, y + h + 3.5]]), fg, 0.8))
        out.append(Prim("text", np.array([[px, y + h + 12]]), fg, size=7.0, text=f"{t:g}",
                        anchor="middle", cls="tick"))
    for t in _nice_ticks(y0, y1):
        py = to_xy([x0], [t])[0, 1]
        out.append(Prim("poly", np.array([[x - 3.5, py], [x, py]]), fg, 0.8))
        out.append(Prim("text", np.array([[x - 5, py + 2.5]]), fg, size=7.0, text=f"{t:g}",
                        anchor="end", cls="tick"))
    if ax.xlabel:
        out.append(Prim("text", np.array([[x + w / 2, y + h + 24]]), fg, size=8.0,
                        text=ax.xlabel, anchor="middle", cls="label"))
    if ax.ylabel:
        out.append(Prim("text", np.array([[x - 30, y + h / 2]]), fg, size=8.0, text=ax.ylabel,
                        anchor="middle", cls="label"))


def _view_axes(elev, azim):
    """The screen's right and up unit vectors for a view from elevation
    ``elev`` and azimuth ``azim`` (degrees), as matplotlib's 3D axes
    orient them."""
    e, a = math.radians(elev), math.radians(azim)
    right = np.array([-math.sin(a), math.cos(a), 0.0])
    up = np.array([-math.sin(e) * math.cos(a), -math.sin(e) * math.sin(a), math.cos(e)])
    return right, up


def _axes_3d(ax, rect, fg, out):
    x, y, w, h = rect
    lims = [ax.get_xlim(), ax.get_ylim(), ax.get_zlim()]
    aspect = np.array(BOX_ASPECT) / max(BOX_ASPECT)
    right, up = _view_axes(ax.elev, ax.azim)

    def unit(xs, ys, zs):  # data -> the box [-aspect/2, aspect/2]
        p = [(np.asarray(v, dtype=np.float64) - lo) / (hi - lo) - 0.5
             for v, (lo, hi) in zip((xs, ys, zs), lims)]
        return np.stack(p, axis=-1) * aspect

    corners = np.array([[i, j, k] for i in (-0.5, 0.5) for j in (-0.5, 0.5)
                        for k in (-0.5, 0.5)]) * aspect
    su, sv = corners @ right, corners @ up
    scale = min(w / (su.max() - su.min()), h / (sv.max() - sv.min()))
    cx, cy = x + w / 2, y + h / 2
    mu, mv = (su.max() + su.min()) / 2, (sv.max() + sv.min()) / 2

    def screen(p):
        return np.stack([cx + (p @ right - mu) * scale, cy - (p @ up - mv) * scale], axis=-1)

    def to_xy(xs, ys, zs):
        return screen(unit(xs, ys, zs))

    box = screen(corners)
    for i in range(8):
        for j in range(i + 1, 8):
            if np.count_nonzero(corners[i] != corners[j]) == 1:
                out.append(Prim("poly", box[[i, j]], "#808080", 0.5))
    # each axis's label beside the middle of its lowest edge on the screen
    for k, label in enumerate((ax.xlabel, ax.ylabel, ax.zlabel)):
        if not label:
            continue
        edges = [(i, j) for i in range(8) for j in range(i + 1, 8)
                 if np.nonzero(corners[i] != corners[j])[0].tolist() == [k]]
        i, j = max(edges, key=lambda e: (box[e[0], 1] + box[e[1], 1]))
        mid = (box[i] + box[j]) / 2
        out.append(Prim("text", mid[None] + [0.0, 14.0], fg, size=8.0, text=label,
                        anchor="middle", cls="label"))
    for s in ax.series:
        _series_prims(s, to_xy, None, out)


def _display_list(fig):
    W, H = fig.figsize[0] * 72.0, fig.figsize[1] * 72.0
    bg, fg = _colours(fig)
    out = [Prim("rect", np.array([[0.0, 0.0], [W, H]]), bg, cls="background")]
    cw, ch = W / fig.ncols, H / fig.nrows
    for r, row in enumerate(fig.axes):
        for c, ax in enumerate(row):
            if not ax.visible:
                continue
            cx, cy = c * cw, r * ch
            rect = (cx + 0.14 * cw, cy + 0.14 * ch, 0.80 * cw, 0.66 * ch)
            if ax.projection == "3d":
                _axes_3d(ax, (cx + 0.05 * cw, cy + 0.12 * ch, 0.90 * cw, 0.80 * ch), fg, out)
            else:
                _axes_2d(ax, rect, fg, bg, out)
            if ax.title:
                out.append(Prim("text", np.array([[cx + 0.54 * cw, cy + 0.10 * ch]]), fg,
                                size=9.0, text=ax.title, anchor="middle", cls="title"))
            if ax.show_legend:
                _legend_prims(ax, rect[0] + rect[2], rect[1], fg, bg, out)
    return out


def _png_text(fig):
    """The words a PNG cannot draw, as (keyword, text) pairs."""
    pairs = []
    titles = [ax.title for ax in fig.flat if ax.title]
    if titles:
        pairs.append(("Title", "; ".join(titles)))
    for k, ax in enumerate(fig.flat, 1):
        for name in ("title", "xlabel", "ylabel", "zlabel"):
            if getattr(ax, name):
                pairs.append((f"axes {k} {name}", getattr(ax, name)))
        labels = [s.label for s in ax.series if s.label and ax.show_legend]
        if labels:
            pairs.append((f"axes {k} legend", "; ".join(labels)))
        texts = [s.text for s in ax.texts]
        if texts:
            pairs.append((f"axes {k} text", "; ".join(texts)))
        for j, s in enumerate(ax.patches, 1):
            left, height, width = s.data
            edges = np.append(left, left[-1:] + width[-1:]) if left.size else left
            pairs.append((f"axes {k} bars {j} edges", " ".join(repr(float(v)) for v in edges)))
            pairs.append((f"axes {k} bars {j} heights",
                          " ".join(repr(float(v)) for v in height)))
    return pairs


# --------------------------------------------------------------------------
# SVG
# --------------------------------------------------------------------------


def _esc(s):
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            .replace('"', "&quot;"))


def _svg(fig, prims):
    W, H = fig.figsize[0] * 72.0, fig.figsize[1] * 72.0
    clips, body = {}, []
    for p in prims:
        attr = f'class="{p.cls}"'
        if p.clip is not None:
            if p.clip not in clips:
                clips[p.clip] = f"clip{len(clips)}"
            attr += f' clip-path="url(#{clips[p.clip]})"'
        op = f' opacity="{p.alpha:g}"' if p.alpha != 1.0 else ""
        if p.kind == "poly":
            pts = " ".join(f"{u:.2f},{v:.2f}" for u, v in p.pts)
            body.append(f'<polyline {attr} points="{pts}" fill="none" stroke="{p.color}" '
                        f'stroke-width="{p.width:g}" stroke-linejoin="round" '
                        f'stroke-linecap="round"{op}/>')
        elif p.kind == "marks":
            for u, v in p.pts:
                if p.shape == "s":
                    body.append(f'<rect {attr} x="{u - p.size:.2f}" y="{v - p.size:.2f}" '
                                f'width="{2 * p.size:.2f}" height="{2 * p.size:.2f}" '
                                f'fill="{p.color}"{op}/>')
                else:
                    body.append(f'<circle {attr} cx="{u:.2f}" cy="{v:.2f}" r="{p.size:.2f}" '
                                f'fill="{p.color}"{op}/>')
        elif p.kind == "rect":
            (u, v), (w, h) = p.pts
            edge = f' stroke="{p.edge}" stroke-width="{p.width:g}"' if p.edge else ""
            body.append(f'<rect {attr} x="{u:.2f}" y="{v:.2f}" width="{w:.2f}" '
                        f'height="{h:.2f}" fill="{p.color}"{edge}{op}/>')
        else:
            (u, v), = p.pts
            body.append(f'<text {attr} x="{u:.2f}" y="{v:.2f}" font-family="Helvetica, Arial, '
                        f'sans-serif" font-size="{p.size:g}" text-anchor="{p.anchor}" '
                        f'fill="{p.color}">{_esc(p.text)}</text>')
    defs = "".join(f'<clipPath id="{name}"><rect x="{c[0]:.2f}" y="{c[1]:.2f}" '
                   f'width="{c[2]:.2f}" height="{c[3]:.2f}"/></clipPath>'
                   for c, name in clips.items())
    return ('<?xml version="1.0" encoding="utf-8"?>\n'
            f'<svg xmlns="http://www.w3.org/2000/svg" version="1.1" width="{W:g}pt" '
            f'height="{H:g}pt" viewBox="0 0 {W:g} {H:g}">\n<defs>{defs}</defs>\n'
            + "\n".join(body) + "\n</svg>\n")


# --------------------------------------------------------------------------
# PDF
# --------------------------------------------------------------------------

#: the control-point distance of a quarter circle drawn by one Bezier curve
KAPPA = 0.5522847498


def _rgb(colour):
    c = colour.lstrip("#")
    return tuple(int(c[i:i + 2], 16) / 255.0 for i in (0, 2, 4))


def _pdf_string(s):
    b = s.encode("latin-1", "replace")
    return b.replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(b")", b"\\)")


def _pdf_circle(u, v, r):
    """A filled circle as four Bezier quarter arcs, counter-clockwise
    from (u + r, v)."""
    k = r * KAPPA
    arcs = [((u + r, v + k), (u + k, v + r), (u, v + r)),
            ((u - k, v + r), (u - r, v + k), (u - r, v)),
            ((u - r, v - k), (u - k, v - r), (u, v - r)),
            ((u + k, v - r), (u + r, v - k), (u + r, v))]
    path = [f"{u + r:.2f} {v:.2f} m"] + [
        " ".join(f"{a:.2f} {b:.2f}" for a, b in arc) + " c" for arc in arcs]
    return (" ".join(path) + " f").encode()


def _pdf(fig, prims):
    W, H = fig.figsize[0] * 72.0, fig.figsize[1] * 72.0
    alphas = sorted({p.alpha for p in prims if p.alpha != 1.0})
    gs = {a: f"/A{i}" for i, a in enumerate(alphas)}
    ops = [b"1 J 1 j"]

    def fy(v):
        return H - v

    for p in prims:
        if p.kind == "rect" and p.color == "none" and not p.edge:
            continue
        ops.append(b"q")
        if p.clip is not None:
            u, v, w, h = p.clip
            ops.append(f"{u:.2f} {fy(v + h):.2f} {w:.2f} {h:.2f} re W n".encode())
        if p.alpha != 1.0:
            ops.append(f"{gs[p.alpha]} gs".encode())
        if p.color != "none":
            r, g, b = _rgb(p.color)
            ops.append(f"{r:.4f} {g:.4f} {b:.4f} RG {r:.4f} {g:.4f} {b:.4f} rg".encode())
        if p.kind == "poly":
            (u, v), rest = p.pts[0], p.pts[1:]
            path = [f"{p.width:g} w {u:.2f} {fy(v):.2f} m"]
            path += [f"{a:.2f} {fy(b):.2f} l" for a, b in rest]
            ops.append((" ".join(path) + " S").encode())
        elif p.kind == "marks":
            r = p.size
            for u, v in p.pts:
                v = fy(v)
                if p.shape == "s":
                    ops.append(f"{u - r:.2f} {v - r:.2f} {2 * r:.2f} {2 * r:.2f} re f".encode())
                else:
                    ops.append(_pdf_circle(u, v, r))
        elif p.kind == "rect":
            (u, v), (w, h) = p.pts
            box = f"{u:.2f} {fy(v + h):.2f} {w:.2f} {h:.2f} re"
            if p.color != "none":
                ops.append(f"{box} f".encode())
            if p.edge:
                r, g, b = _rgb(p.edge)
                ops.append(f"{r:.4f} {g:.4f} {b:.4f} RG {p.width:g} w {box} S".encode())
        else:
            (u, v), = p.pts
            width = 0.5 * p.size * len(p.text)  # Helvetica's mean advance, near enough
            u -= {"start": 0.0, "middle": width / 2, "end": width}[p.anchor]
            ops.append(b"BT /F1 " + f"{p.size:g} Tf {u:.2f} {fy(v):.2f} Td (".encode()
                       + _pdf_string(p.text) + b") Tj ET")
        ops.append(b"Q")
    content = b"\n".join(ops)
    ext = b" ".join(f"{name} << /Type /ExtGState /CA {a:g} /ca {a:g} >>".encode()
                    for a, name in gs.items())
    objects = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {W:g} {H:g}] /Contents 4 0 R "
         f"/Resources << /Font << /F1 5 0 R >> /ExtGState << ").encode() + ext + b" >> >> >>",
        f"<< /Length {len(content)} >>\nstream\n".encode() + content + b"\nendstream",
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica /Encoding /WinAnsiEncoding >>",
    ]
    out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = []
    for i, body in enumerate(objects, 1):
        offsets.append(len(out))
        out += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
    xref = len(out)
    out += f"xref\n0 {len(objects) + 1}\n".encode() + b"0000000000 65535 f \n"
    out += b"".join(f"{o:010d} 00000 n \n".encode() for o in offsets)
    out += (f"trailer\n<< /Size {len(objects) + 1} /Root 1 0 R >>\nstartxref\n{xref}\n"
            "%%EOF\n").encode()
    return bytes(out)


# --------------------------------------------------------------------------
# PNG: a numpy rasteriser
# --------------------------------------------------------------------------


def _blend(img, idx, colour, alpha):
    """Blend ``colour`` at ``alpha`` into the flat pixel indices ``idx``,
    each pixel once."""
    if idx.size == 0:
        return
    flat = img.reshape(-1, 3)
    idx = np.unique(idx)
    c = np.array(_rgb(colour), np.float32) * 255.0
    flat[idx] = flat[idx] * (1.0 - alpha) + c * alpha


def _stamp(img, centres, offsets, clip):
    """Flat indices of ``offsets`` (K, 2) stamped at every integer centre
    (M, 2) inside the image and the clip box (pixels)."""
    H, W = img.shape[:2]
    p = (centres[:, None, :] + offsets[None]).reshape(-1, 2)
    x0, y0, x1, y1 = clip
    ok = (p[:, 0] >= max(x0, 0)) & (p[:, 0] < min(x1, W)) & (p[:, 1] >= max(y0, 0)) & (
        p[:, 1] < min(y1, H))
    p = p[ok]
    return p[:, 1] * W + p[:, 0]


def _disc(r):
    n = int(math.ceil(r))
    g = np.arange(-n, n + 1)
    dx, dy = np.meshgrid(g, g)
    keep = dx * dx + dy * dy <= max(r, 0.5) ** 2
    return np.stack([dx[keep], dy[keep]], axis=-1)


def _square(r):
    n = max(int(round(r)), 0)
    g = np.arange(-n, n + 1)
    dx, dy = np.meshgrid(g, g)
    return np.stack([dx.ravel(), dy.ravel()], axis=-1)


def _dda(pts):
    """Pixel centres along the polyline pts (K, 2): each segment sampled
    at steps of at most half a pixel."""
    if len(pts) == 1:
        return np.round(pts).astype(np.int64)
    a, b = pts[:-1], pts[1:]
    n = np.maximum(np.ceil(2 * np.abs(b - a).max(axis=1)).astype(np.int64), 1)
    seg = np.repeat(np.arange(len(a)), n + 1)
    t = np.concatenate([np.linspace(0.0, 1.0, k + 1) for k in n])
    p = a[seg] + (b[seg] - a[seg]) * t[:, None]
    return np.round(p).astype(np.int64)


def _raster(fig, prims, factor=1):
    s = fig.dpi / 72.0 * factor
    Wp, Hp = int(round(fig.figsize[0] * fig.dpi)), int(round(fig.figsize[1] * fig.dpi))
    W, H = Wp * factor, Hp * factor
    img = np.zeros((H, W, 3), np.float32)
    for p in prims:
        clip = (0, 0, W, H)
        if p.clip is not None:
            u, v, w, h = (c * s for c in p.clip)
            clip = (int(math.floor(u)), int(math.floor(v)), int(math.ceil(u + w)),
                    int(math.ceil(v + h)))
        if p.kind == "poly":
            half = max(p.width * s, 1.0) / 2.0
            _blend(img, _stamp(img, _dda(p.pts * s), _disc(half - 0.5) if half > 1 else
                               _square(0), clip), p.color, p.alpha)
        elif p.kind == "marks" and len(p.pts):
            shape = _square if p.shape == "s" else _disc
            centres = np.round(p.pts * s).astype(np.int64)
            _blend(img, _stamp(img, centres, shape(p.size * s), clip), p.color, p.alpha)
        elif p.kind == "rect":
            (u, v), (w, h) = p.pts * s
            x0, y0 = max(int(round(u)), clip[0], 0), max(int(round(v)), clip[1], 0)
            x1 = min(int(round(u + w)), clip[2], W)
            y1 = min(int(round(v + h)), clip[3], H)
            if p.color != "none" and x1 > x0 and y1 > y0:
                ys, xs = np.mgrid[y0:y1, x0:x1]
                _blend(img, (ys * W + xs).ravel(), p.color, p.alpha)
            if p.edge:
                ring = np.array([[u, v], [u + w, v], [u + w, v + h], [u, v + h], [u, v]])
                _blend(img, _stamp(img, _dda(ring), _square(0), clip), p.edge, 1.0)
    if factor > 1:
        img = img.reshape(Hp, factor, Wp, factor, 3).mean(axis=(1, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)
