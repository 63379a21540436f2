"""PNG rasterization of the show render plan.

Counterpart of lib_tsshow/src/lib.rs:8-28 (svg_to_png via resvg at a
configurable zoom): rasterizes the same RenderPlan that plan_to_svg
serializes, so the PNG and SVG outputs show identical layouts.  Uses
Pillow when available (text + bezier curves); raises a clear error
otherwise so the CLI can point the user at the SVG output.
"""

from __future__ import annotations

from .svg import CW, RenderPlan


def render_png(plan: RenderPlan, path: str, zoom: float = 2.0) -> None:
    """Rasterize ``plan`` to a PNG file at ``zoom`` pixels per SVG unit."""
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:  # pragma: no cover - PIL is present in CI
        raise RuntimeError(
            "PNG rendering requires Pillow; emit SVG with -s instead"
        ) from e

    W = max(1, int(plan.width * zoom))
    H = max(1, int(plan.height * zoom))
    img = Image.new("RGB", (W, H), "white")
    draw = ImageDraw.Draw(img)

    def font_at(px: float):
        try:
            return ImageFont.truetype("DejaVuSansMono.ttf", int(px))
        except OSError:
            try:
                return ImageFont.load_default(size=int(px))
            except TypeError:  # very old Pillow
                return ImageFont.load_default()

    base_px = 13 * zoom
    fonts = {}
    for r in plan.runs:
        px = int(base_px * r.scale)
        if px not in fonts:
            fonts[px] = font_at(px)
        f = fonts[px]
        # Fixed per-character advance keeps columns aligned even when the
        # fallback font is proportional.
        adv = CW * zoom * r.scale
        x = r.x * zoom
        ybase = r.y * zoom
        for ch in r.text:
            if ch != " ":
                draw.text((x, ybase), ch, fill=r.color, font=f, anchor="ls")
            x += adv

    for c in plan.curves:
        pts = []
        n = 24
        for k in range(n + 1):
            t = k / n
            mt = 1 - t
            x = (
                mt**3 * c.x0
                + 3 * mt**2 * t * c.cx0
                + 3 * mt * t**2 * c.cx1
                + t**3 * c.x1
            )
            y = (
                mt**3 * c.y0
                + 3 * mt**2 * t * c.cy0
                + 3 * mt * t**2 * c.cy1
                + t**3 * c.y1
            )
            pts.append((x * zoom, y * zoom))
        draw.line(pts, fill=c.color, width=max(1, int(zoom)))
        # Arrowhead at the end, oriented along the final segment.
        (x0, y0), (x1, y1) = pts[-2], pts[-1]
        dx, dy = x1 - x0, y1 - y0
        norm = (dx * dx + dy * dy) ** 0.5 or 1.0
        dx, dy = dx / norm, dy / norm
        size = 5 * zoom
        left = (x1 - size * dx + size * 0.5 * dy, y1 - size * dy - size * 0.5 * dx)
        right = (x1 - size * dx - size * 0.5 * dy, y1 - size * dy + size * 0.5 * dx)
        draw.polygon([(x1, y1), left, right], fill=c.color)

    img.save(path, "PNG")
