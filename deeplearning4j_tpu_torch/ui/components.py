"""UI component library: charts, tables, text, accordion.

The port of ``deeplearning4j_tpu/ui/components.py``, a copy: the module
is numpy and the standard library only, and renders the same strings.
Reference analog: deeplearning4j-ui-components
(``org/deeplearning4j/ui/components/``: Chart{Line,Scatter,Histogram,
HorizontalBar,StackedArea,Timeline}.java, ComponentTable.java,
ComponentText.java, DecoratorAccordion.java and their Style classes). The
reference serializes components to JSON and renders them client-side via
dl4j-ui.js/d3; here the same component model renders SERVER-side to
self-contained SVG/HTML (no JS dependency) while keeping the JSON
contract (to_dict/from_dict round-trip) so headless consumers can still
get structured data.

Used by ui/server.py for the training dashboard, and usable standalone:

    chart = ChartLine("score", series=[("train", iters, scores)])
    open("score.svg", "w").write(chart.render_svg())
"""

from __future__ import annotations

import dataclasses
import html as _html

import numpy as np

_PALETTE = ["#2066a8", "#d1605e", "#50a14f", "#9467bd", "#c49c44",
            "#17a2b2", "#e377c2", "#8c564b"]


@dataclasses.dataclass
class Style:
    """Chart/table styling (reference: api/Style.java + StyleChart.java —
    the subset that matters for server-side SVG)."""
    width: int = 640
    height: int = 320
    margin_top: int = 24
    margin_bottom: int = 36
    margin_left: int = 56
    margin_right: int = 16
    background: str = "#ffffff"
    stroke_width: float = 1.5
    point_size: float = 2.5
    font_size: int = 11


class Component:
    """JSON-serializable UI component (reference: api/Component.java)."""

    component_type = "component"

    def to_dict(self):
        raise NotImplementedError

    @staticmethod
    def from_dict(d):
        cls = _COMPONENT_TYPES[d["componentType"]]
        return cls._from_dict(d)

    def render_html(self):
        raise NotImplementedError


def _axes(style, x_min, x_max, y_min, y_max, title, x_ticks=6, y_ticks=5):
    """Common SVG scaffolding: background, title, tick labels, gridlines.
    Returns (svg_parts, sx, sy) where sx/sy map data coords to pixels."""
    w, h = style.width, style.height
    il = style.margin_left
    it = style.margin_top
    iw = w - il - style.margin_right
    ih = h - it - style.margin_bottom
    if x_max <= x_min:
        x_max = x_min + 1.0
    if y_max <= y_min:
        y_max = y_min + 1.0

    def sx(x):
        return il + (x - x_min) / (x_max - x_min) * iw

    def sy(y):
        return it + ih - (y - y_min) / (y_max - y_min) * ih

    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
             f'height="{h}" viewBox="0 0 {w} {h}">',
             f'<rect width="{w}" height="{h}" fill="{style.background}"/>']
    if title:
        parts.append(f'<text x="{w / 2}" y="{it - 8}" text-anchor="middle" '
                     f'font-size="{style.font_size + 2}" '
                     f'font-family="sans-serif">{_html.escape(title)}</text>')
    for i in range(y_ticks + 1):
        yv = y_min + (y_max - y_min) * i / y_ticks
        yp = sy(yv)
        parts.append(f'<line x1="{il}" y1="{yp:.1f}" x2="{il + iw}" '
                     f'y2="{yp:.1f}" stroke="#e0e0e0" stroke-width="0.5"/>')
        parts.append(f'<text x="{il - 6}" y="{yp + 3:.1f}" text-anchor="end" '
                     f'font-size="{style.font_size}" '
                     f'font-family="sans-serif">{yv:.4g}</text>')
    for i in range(x_ticks + 1):
        xv = x_min + (x_max - x_min) * i / x_ticks
        xp = sx(xv)
        parts.append(f'<text x="{xp:.1f}" y="{it + ih + 16}" '
                     f'text-anchor="middle" font-size="{style.font_size}" '
                     f'font-family="sans-serif">{xv:.4g}</text>')
    parts.append(f'<rect x="{il}" y="{it}" width="{iw}" height="{ih}" '
                 f'fill="none" stroke="#808080" stroke-width="1"/>')
    return parts, sx, sy


def _legend(parts, style, names):
    x = style.margin_left + 8
    y = style.margin_top + 14
    for i, name in enumerate(names):
        c = _PALETTE[i % len(_PALETTE)]
        parts.append(f'<rect x="{x}" y="{y - 8}" width="10" height="10" '
                     f'fill="{c}"/>')
        parts.append(f'<text x="{x + 14}" y="{y + 1}" '
                     f'font-size="{style.font_size}" '
                     f'font-family="sans-serif">{_html.escape(name)}</text>')
        x += 20 + 7 * len(name)


class _Chart(Component):
    """Shared base for the chart family (reference: chart/Chart.java)."""

    def __init__(self, title, style=None):
        self.title = title
        self.style = style or Style()

    def render_html(self):
        return self.render_svg()


class ChartLine(_Chart):
    """Multi-series line chart (reference: chart/ChartLine.java)."""

    component_type = "chart-line"

    def __init__(self, title, series=None, style=None):
        """series: list of (name, xs, ys)."""
        super().__init__(title, style)
        self.series = [(n, np.asarray(x, float), np.asarray(y, float))
                       for n, x, y in (series or [])]

    def add_series(self, name, xs, ys):
        self.series.append((name, np.asarray(xs, float), np.asarray(ys, float)))
        return self

    def _bounds(self):
        """Data bounds over FINITE values only — one NaN (e.g. a diverged
        run logging score=NaN) must not blank the whole chart."""
        xs = np.concatenate([x for _, x, _ in self.series]) if self.series \
            else np.zeros(1)
        ys = np.concatenate([y for _, _, y in self.series]) if self.series \
            else np.zeros(1)
        xs = xs[np.isfinite(xs)]
        ys = ys[np.isfinite(ys)]
        if not len(xs):
            xs = np.zeros(1)
        if not len(ys):
            ys = np.zeros(1)
        return (float(xs.min()), float(xs.max()),
                float(ys.min()), float(ys.max()))

    def render_svg(self):
        x0, x1, y0, y1 = self._bounds()
        parts, sx, sy = _axes(self.style, x0, x1, y0, y1, self.title)
        for i, (name, xs, ys) in enumerate(self.series):
            c = _PALETTE[i % len(_PALETTE)]
            pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys)
                           if np.isfinite(x) and np.isfinite(y))
            parts.append(f'<polyline points="{pts}" fill="none" stroke="{c}" '
                         f'stroke-width="{self.style.stroke_width}"/>')
        _legend(parts, self.style, [n for n, _, _ in self.series])
        parts.append("</svg>")
        return "".join(parts)

    def to_dict(self):
        return {"componentType": self.component_type, "title": self.title,
                "series": [{"name": n, "x": list(map(float, x)),
                            "y": list(map(float, y))}
                           for n, x, y in self.series]}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["title"],
                   [(s["name"], s["x"], s["y"]) for s in d["series"]])


class ChartScatter(ChartLine):
    """Scatter chart (reference: chart/ChartScatter.java)."""

    component_type = "chart-scatter"

    def render_svg(self):
        x0, x1, y0, y1 = self._bounds()
        parts, sx, sy = _axes(self.style, x0, x1, y0, y1, self.title)
        for i, (name, xs, ys) in enumerate(self.series):
            c = _PALETTE[i % len(_PALETTE)]
            for x, y in zip(xs, ys):
                if not (np.isfinite(x) and np.isfinite(y)):
                    continue
                parts.append(f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" '
                             f'r="{self.style.point_size}" fill="{c}"/>')
        _legend(parts, self.style, [n for n, _, _ in self.series])
        parts.append("</svg>")
        return "".join(parts)


class ChartHistogram(_Chart):
    """Histogram of [lower, upper, count] bins (reference:
    chart/ChartHistogram.java)."""

    component_type = "chart-histogram"

    def __init__(self, title, bins=None, style=None):
        """bins: list of (lower_bound, upper_bound, y_value)."""
        super().__init__(title, style)
        self.bins = [(float(a), float(b), float(y)) for a, b, y in (bins or [])]

    @classmethod
    def of(cls, title, values, n_bins=30, style=None):
        counts, edges = np.histogram(np.asarray(values).reshape(-1), n_bins)
        return cls(title, list(zip(edges[:-1], edges[1:], counts)), style)

    def render_svg(self):
        if self.bins:
            x0, x1 = self.bins[0][0], self.bins[-1][1]
            y1 = max(y for _, _, y in self.bins)
        else:
            x0, x1, y1 = 0.0, 1.0, 1.0
        parts, sx, sy = _axes(self.style, x0, x1, 0.0, y1, self.title)
        for lo, hi, y in self.bins:
            parts.append(
                f'<rect x="{sx(lo):.1f}" y="{sy(y):.1f}" '
                f'width="{max(sx(hi) - sx(lo) - 0.5, 0.5):.1f}" '
                f'height="{max(sy(0) - sy(y), 0):.1f}" '
                f'fill="{_PALETTE[0]}" stroke="none"/>')
        parts.append("</svg>")
        return "".join(parts)

    def to_dict(self):
        return {"componentType": self.component_type, "title": self.title,
                "bins": [list(b) for b in self.bins]}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["title"], d["bins"])


class ChartHorizontalBar(_Chart):
    """Named horizontal bars (reference: chart/ChartHorizontalBar.java)."""

    component_type = "chart-horizontal-bar"

    def __init__(self, title, names=None, values=None, style=None):
        super().__init__(title, style)
        self.names = list(names or [])
        self.values = [float(v) for v in (values or [])]

    def render_svg(self):
        st = self.style
        n = max(len(self.names), 1)
        vmax = max(self.values + [1e-12])
        vmin = min(self.values + [0.0])
        parts, sx, _ = _axes(st, vmin, vmax, 0, n, self.title, y_ticks=1)
        ih = st.height - st.margin_top - st.margin_bottom
        bar_h = ih / n * 0.7
        for i, (name, v) in enumerate(zip(self.names, self.values)):
            y = st.margin_top + ih * i / n + ih / n * 0.15
            parts.append(f'<rect x="{sx(min(0, v)):.1f}" y="{y:.1f}" '
                         f'width="{abs(sx(v) - sx(0)):.1f}" '
                         f'height="{bar_h:.1f}" '
                         f'fill="{_PALETTE[i % len(_PALETTE)]}"/>')
            parts.append(f'<text x="{st.margin_left + 4}" '
                         f'y="{y + bar_h / 2 + 3:.1f}" '
                         f'font-size="{st.font_size}" '
                         f'font-family="sans-serif">'
                         f'{_html.escape(str(name))}</text>')
        parts.append("</svg>")
        return "".join(parts)

    def to_dict(self):
        return {"componentType": self.component_type, "title": self.title,
                "names": self.names, "values": self.values}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["title"], d["names"], d["values"])


class ChartStackedArea(_Chart):
    """Stacked area chart (reference: chart/ChartStackedArea.java)."""

    component_type = "chart-stacked-area"

    def __init__(self, title, x=None, series=None, style=None):
        """x: shared x values; series: list of (name, ys)."""
        super().__init__(title, style)
        self.x = np.asarray(x if x is not None else [], float)
        self.series = [(n, np.asarray(y, float)) for n, y in (series or [])]

    def render_svg(self):
        if not len(self.x) or not self.series:
            return ChartLine(self.title, [], self.style).render_svg()
        # non-finite values stack as 0 so one NaN can't blank the chart
        # (same defense as ChartLine._bounds)
        stack = np.cumsum([np.where(np.isfinite(y), y, 0.0)
                           for _, y in self.series], axis=0)
        parts, sx, sy = _axes(self.style, float(self.x.min()),
                              float(self.x.max()), 0.0,
                              float(stack[-1].max()), self.title)
        prev = np.zeros_like(self.x)
        for i, (name, _) in enumerate(self.series):
            top = stack[i]
            fwd = [f"{sx(x):.1f},{sy(t):.1f}" for x, t in zip(self.x, top)]
            back = [f"{sx(x):.1f},{sy(p):.1f}"
                    for x, p in zip(self.x[::-1], prev[::-1])]
            parts.append(f'<polygon points="{" ".join(fwd + back)}" '
                         f'fill="{_PALETTE[i % len(_PALETTE)]}" '
                         f'fill-opacity="0.7" stroke="none"/>')
            prev = top
        _legend(parts, self.style, [n for n, _ in self.series])
        parts.append("</svg>")
        return "".join(parts)

    def to_dict(self):
        return {"componentType": self.component_type, "title": self.title,
                "x": list(map(float, self.x)),
                "series": [{"name": n, "y": list(map(float, y))}
                           for n, y in self.series]}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["title"], d["x"],
                   [(s["name"], s["y"]) for s in d["series"]])


class ChartTimeline(_Chart):
    """Lanes of [start, end, label] entries (reference:
    chart/ChartTimeline.java) — ETL vs compute vs callback phases etc."""

    component_type = "chart-timeline"

    def __init__(self, title, lanes=None, style=None):
        """lanes: list of (lane_name, [(start, end, label), ...])."""
        super().__init__(title, style)
        self.lanes = [(n, [(float(a), float(b), str(l)) for a, b, l in ent])
                      for n, ent in (lanes or [])]

    def render_svg(self):
        st = self.style
        all_t = [t for _, ent in self.lanes for a, b, _ in ent
                 for t in (a, b)] or [0.0, 1.0]
        n = max(len(self.lanes), 1)
        parts, sx, _ = _axes(st, min(all_t), max(all_t), 0, n, self.title,
                             y_ticks=1)
        ih = st.height - st.margin_top - st.margin_bottom
        for i, (name, entries) in enumerate(self.lanes):
            y = st.margin_top + ih * i / n + ih / n * 0.15
            h = ih / n * 0.7
            for j, (a, b, label) in enumerate(entries):
                parts.append(f'<rect x="{sx(a):.1f}" y="{y:.1f}" '
                             f'width="{max(sx(b) - sx(a), 0.5):.1f}" '
                             f'height="{h:.1f}" '
                             f'fill="{_PALETTE[j % len(_PALETTE)]}" '
                             f'fill-opacity="0.8"/>')
                if label:
                    parts.append(
                        f'<text x="{(sx(a) + sx(b)) / 2:.1f}" '
                        f'y="{y + h / 2 + 3:.1f}" text-anchor="middle" '
                        f'font-size="{st.font_size - 1}" '
                        f'font-family="sans-serif" fill="#ffffff">'
                        f"{_html.escape(label)}</text>")
            parts.append(f'<text x="4" y="{y + h / 2 + 3:.1f}" '
                         f'font-size="{st.font_size}" '
                         f'font-family="sans-serif">'
                         f'{_html.escape(name)}</text>')
        parts.append("</svg>")
        return "".join(parts)

    def to_dict(self):
        return {"componentType": self.component_type, "title": self.title,
                "lanes": [{"name": n, "entries": [list(e) for e in ent]}
                          for n, ent in self.lanes]}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["title"],
                   [(l["name"], [tuple(e) for e in l["entries"]])
                    for l in d["lanes"]])


class ComponentTable(Component):
    """HTML table (reference: table/ComponentTable.java)."""

    component_type = "component-table"

    def __init__(self, header=None, content=None):
        self.header = [str(h) for h in (header or [])]
        self.content = [[str(c) for c in row] for row in (content or [])]

    def render_html(self):
        rows = ['<table style="border-collapse:collapse;'
                'font-family:sans-serif;font-size:12px">']
        if self.header:
            rows.append("<tr>" + "".join(
                f'<th style="border:1px solid #999;padding:3px 8px;'
                f'background:#f0f0f0">{_html.escape(h)}</th>'
                for h in self.header) + "</tr>")
        for row in self.content:
            rows.append("<tr>" + "".join(
                f'<td style="border:1px solid #999;padding:3px 8px">'
                f"{_html.escape(c)}</td>" for c in row) + "</tr>")
        rows.append("</table>")
        return "".join(rows)

    def to_dict(self):
        return {"componentType": self.component_type, "header": self.header,
                "content": self.content}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["header"], d["content"])


class ComponentText(Component):
    """Styled text block (reference: text/ComponentText.java)."""

    component_type = "component-text"

    def __init__(self, text, *, size=12, bold=False, color="#000000"):
        self.text = str(text)
        self.size = size
        self.bold = bold
        self.color = color

    def render_html(self):
        weight = "bold" if self.bold else "normal"
        return (f'<div style="font-family:sans-serif;font-size:{self.size}px;'
                f'font-weight:{weight};color:{self.color}">'
                f"{_html.escape(self.text)}</div>")

    def to_dict(self):
        return {"componentType": self.component_type, "text": self.text,
                "size": self.size, "bold": self.bold, "color": self.color}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["text"], size=d.get("size", 12),
                   bold=d.get("bold", False), color=d.get("color", "#000000"))


class DecoratorAccordion(Component):
    """Collapsible section wrapping inner components (reference:
    decorator/DecoratorAccordion.java) — <details>/<summary>, no JS."""

    component_type = "decorator-accordion"

    def __init__(self, title, components=None, default_collapsed=False):
        self.title = title
        self.components = list(components or [])
        self.default_collapsed = default_collapsed

    def render_html(self):
        open_attr = "" if self.default_collapsed else " open"
        inner = "".join(c.render_html() for c in self.components)
        return (f"<details{open_attr}>"
                f'<summary style="font-family:sans-serif;cursor:pointer">'
                f"{_html.escape(self.title)}</summary>{inner}</details>")

    def to_dict(self):
        return {"componentType": self.component_type, "title": self.title,
                "defaultCollapsed": self.default_collapsed,
                "components": [c.to_dict() for c in self.components]}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["title"], [Component.from_dict(c)
                                for c in d["components"]],
                   d.get("defaultCollapsed", False))


_COMPONENT_TYPES = {c.component_type: c for c in
                    (ChartLine, ChartScatter, ChartHistogram,
                     ChartHorizontalBar, ChartStackedArea, ChartTimeline,
                     ComponentTable, ComponentText, DecoratorAccordion)}
