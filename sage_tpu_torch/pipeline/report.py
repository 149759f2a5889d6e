"""HTML QC report.

Content parity with the reference's maud report (runner.rs:1242-1802):

1. Results Overview — per-file table (MS2 counts, PSMs/peptides/proteins
   at 1% FDR, median mass error) and an LFQ intensity box plot.
2. Scoring Quality Control — target/decoy discriminant-score histogram,
   posterior-error calibration (PP) plot, q-value histograms at the
   spectrum/peptide/protein levels.
3. Predicted Properties — aligned vs predicted RT and measured vs
   predicted ion-mobility scatter plots for confident (q <= 0.01) PSMs.
4. Configuration — the fully-resolved search parameters.

Rendering is dependency-free inline SVG. Colors follow the validated
default dataviz palette (categorical slots 1-2: blue #2a78d6 target /
orange #eb6834 decoy in light mode, re-stepped for dark), with light and
dark modes driven by CSS custom properties; marks carry native <title>
tooltips, identity is never color-alone (legend + direct labels), and
the overview table doubles as the table view.
"""

from __future__ import annotations

import html
import json
import math
from typing import List, Optional, Sequence

import numpy as np

W, H = 640, 300
PAD_L, PAD_R, PAD_T, PAD_B = 56, 16, 20, 44

_CSS = """
:root { color-scheme: light dark; }
.viz-root {
  --surface-1: #fcfcfb; --page: #f9f9f7;
  --ink-1: #0b0b0b; --ink-2: #52514e; --muted: #898781;
  --grid: #e1e0d9; --baseline: #c3c2b7;
  --series-1: #2a78d6; --series-2: #eb6834;
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  color: var(--ink-1); background: var(--page);
  margin: 0; padding: 24px;
}
@media (prefers-color-scheme: dark) {
  .viz-root {
    --surface-1: #1a1a19; --page: #0d0d0d;
    --ink-1: #ffffff; --ink-2: #c3c2b7; --muted: #898781;
    --grid: #2c2c2a; --baseline: #383835;
    --series-1: #3987e5; --series-2: #d95926;
  }
}
.viz-root h1 { font-size: 22px; font-weight: 650; }
.viz-root h2 { font-size: 16px; font-weight: 600; margin: 28px 0 8px; }
.viz-root p  { color: var(--ink-2); font-size: 13px; max-width: 72ch; }
.card { background: var(--surface-1); border: 1px solid var(--grid);
        border-radius: 8px; padding: 16px; margin: 12px 0; display: inline-block; }
table.qc { border-collapse: collapse; font-size: 12.5px; background: var(--surface-1); }
table.qc th, table.qc td { border: 1px solid var(--grid); padding: 4px 10px;
        text-align: right; font-variant-numeric: tabular-nums; }
table.qc th { color: var(--ink-2); font-weight: 600; }
table.qc td:first-child, table.qc th:first-child { text-align: left; }
.legend { font-size: 12px; color: var(--ink-2); margin: 4px 0; }
.legend .swatch { display: inline-block; width: 10px; height: 10px;
        border-radius: 2px; margin: 0 4px 0 12px; vertical-align: -1px; }
pre.config { background: var(--surface-1); border: 1px solid var(--grid);
        border-radius: 8px; padding: 12px; font-size: 11.5px; overflow-x: auto; }
svg text { font-family: inherit; }
"""


def _axes(x0, x1, y0, y1, xlab, ylab, xticks, yticks, fmt="{:g}"):
    """Hairline gridlines + muted tick labels + axis titles."""
    parts = []
    for tx, px in xticks:
        parts.append(
            f'<line x1="{px:.1f}" y1="{PAD_T}" x2="{px:.1f}" y2="{H-PAD_B}" '
            f'stroke="var(--grid)" stroke-width="1"/>'
        )
        parts.append(
            f'<text x="{px:.1f}" y="{H-PAD_B+16}" fill="var(--muted)" '
            f'font-size="11" text-anchor="middle">{fmt.format(tx)}</text>'
        )
    for ty, py in yticks:
        parts.append(
            f'<line x1="{PAD_L}" y1="{py:.1f}" x2="{W-PAD_R}" y2="{py:.1f}" '
            f'stroke="var(--grid)" stroke-width="1"/>'
        )
        parts.append(
            f'<text x="{PAD_L-6}" y="{py+4:.1f}" fill="var(--muted)" '
            f'font-size="11" text-anchor="end">{fmt.format(ty)}</text>'
        )
    parts.append(
        f'<line x1="{PAD_L}" y1="{H-PAD_B}" x2="{W-PAD_R}" y2="{H-PAD_B}" '
        f'stroke="var(--baseline)" stroke-width="1"/>'
    )
    parts.append(
        f'<text x="{(PAD_L+W-PAD_R)/2}" y="{H-8}" fill="var(--ink-2)" '
        f'font-size="12" text-anchor="middle">{html.escape(xlab)}</text>'
    )
    parts.append(
        f'<text x="14" y="{(PAD_T+H-PAD_B)/2}" fill="var(--ink-2)" font-size="12" '
        f'text-anchor="middle" transform="rotate(-90 14 {(PAD_T+H-PAD_B)/2})">'
        f"{html.escape(ylab)}</text>"
    )
    return "".join(parts)


def _ticks(lo, hi, n=5):
    if not math.isfinite(lo) or not math.isfinite(hi) or hi <= lo:
        return [lo]
    step = (hi - lo) / n
    mag = 10 ** math.floor(math.log10(step))
    for m in (1, 2, 2.5, 5, 10):
        if step <= m * mag:
            step = m * mag
            break
    t0 = math.ceil(lo / step) * step
    out = []
    t = t0
    while t <= hi + 1e-12:
        out.append(round(t, 10))
        t += step
    return out or [lo]


def svg_histogram(
    series: Sequence[tuple], xlab: str, ylab: str = "count", bins: int = 40
) -> str:
    """Overlaid step histograms. series: [(name, cssvar, values array)].
    Two-series target/decoy uses categorical slots 1-2 in fixed order."""
    vals = [np.asarray(v, dtype=np.float64) for _, _, v in series]
    allv = np.concatenate([v[np.isfinite(v)] for v in vals]) if vals else np.zeros(0)
    if allv.size == 0:
        return ""
    lo, hi = float(allv.min()), float(allv.max())
    if hi <= lo:
        hi = lo + 1.0
    edges = np.linspace(lo, hi, bins + 1)
    hists = [np.histogram(v[np.isfinite(v)], bins=edges)[0] for v in vals]
    ymax = max(int(h.max()) for h in hists) or 1

    def px(x):
        return PAD_L + (x - lo) / (hi - lo) * (W - PAD_L - PAD_R)

    def py(y):
        return H - PAD_B - y / ymax * (H - PAD_T - PAD_B)

    xticks = [(t, px(t)) for t in _ticks(lo, hi)]
    yticks = [(t, py(t)) for t in _ticks(0, ymax, 4) if t == int(t)]
    out = [
        f'<svg viewBox="0 0 {W} {H}" width="{W}" height="{H}" role="img">',
        f'<rect x="0" y="0" width="{W}" height="{H}" fill="var(--surface-1)"/>',
        _axes(lo, hi, 0, ymax, xlab, ylab, xticks, yticks),
    ]
    for (name, var, _), hist in zip(series, hists):
        pts = [f"{px(lo):.1f},{py(0):.1f}"]
        for b in range(bins):
            y = py(float(hist[b]))
            pts.append(f"{px(edges[b]):.1f},{y:.1f}")
            pts.append(f"{px(edges[b+1]):.1f},{y:.1f}")
        pts.append(f"{px(hi):.1f},{py(0):.1f}")
        title = html.escape(f"{name}: n={int(hist.sum())}")
        out.append(
            f'<polyline points="{" ".join(pts)}" fill="none" '
            f'stroke="var({var})" stroke-width="2"><title>{title}</title>'
            f"</polyline>"
        )
    out.append("</svg>")
    legend = "".join(
        f'<span class="swatch" style="background: var({var})"></span>'
        f"{html.escape(name)}"
        for name, var, _ in series
    )
    return f'<div class="card">{out and "".join(out)}' + (
        f'<div class="legend">{legend}</div></div>' if len(series) > 1 else "</div>"
    )


def svg_scatter(
    x, y, xlab, ylab, name, identity_line=False, max_points=4000
) -> str:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    ok = np.isfinite(x) & np.isfinite(y)
    x, y = x[ok], y[ok]
    if x.size == 0:
        return ""
    if x.size > max_points:
        idx = np.linspace(0, x.size - 1, max_points).astype(np.int64)
        x, y = x[idx], y[idx]
    lo = float(min(x.min(), y.min())) if identity_line else float(x.min())
    hi = float(max(x.max(), y.max())) if identity_line else float(x.max())
    ylo = lo if identity_line else float(y.min())
    yhi = hi if identity_line else float(y.max())
    if hi <= lo:
        hi = lo + 1.0
    if yhi <= ylo:
        yhi = ylo + 1.0

    def px(v):
        return PAD_L + (v - lo) / (hi - lo) * (W - PAD_L - PAD_R)

    def py(v):
        return H - PAD_B - (v - ylo) / (yhi - ylo) * (H - PAD_T - PAD_B)

    xticks = [(t, px(t)) for t in _ticks(lo, hi)]
    yticks = [(t, py(t)) for t in _ticks(ylo, yhi, 4)]
    out = [
        f'<svg viewBox="0 0 {W} {H}" width="{W}" height="{H}" role="img">',
        f'<rect width="{W}" height="{H}" fill="var(--surface-1)"/>',
        _axes(lo, hi, ylo, yhi, xlab, ylab, xticks, yticks),
    ]
    if identity_line:
        out.append(
            f'<line x1="{px(lo):.1f}" y1="{py(lo):.1f}" x2="{px(hi):.1f}" '
            f'y2="{py(hi):.1f}" stroke="var(--baseline)" stroke-width="1" '
            f'stroke-dasharray="4 3"/>'
        )
    pts = "".join(
        f'<circle cx="{px(a):.1f}" cy="{py(b):.1f}" r="2.5"/>'
        for a, b in zip(x, y)
    )
    out.append(
        f'<g fill="var(--series-1)" fill-opacity="0.35">{pts}'
        f"<title>{html.escape(name)} (n={x.size})</title></g>"
    )
    out.append("</svg>")
    return f'<div class="card">{"".join(out)}</div>'


def svg_boxplot(groups: Sequence[tuple], xlab: str, ylab: str) -> str:
    """groups: [(label, values array)] — per-file LFQ log10 intensities."""
    stats = []
    for label, v in groups:
        v = np.asarray(v, np.float64)
        v = v[np.isfinite(v) & (v > 0)]
        if v.size == 0:
            stats.append((label, None))
            continue
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        iqr = q3 - q1
        lo_w = float(v[v >= q1 - 1.5 * iqr].min())
        hi_w = float(v[v <= q3 + 1.5 * iqr].max())
        stats.append((label, (lo_w, q1, med, q3, hi_w)))
    vals = [s for _, s in stats if s]
    if not vals:
        return ""
    ylo = min(s[0] for s in vals)
    yhi = max(s[4] for s in vals)
    if yhi <= ylo:
        yhi = ylo + 1.0

    def py(v):
        return H - PAD_B - (v - ylo) / (yhi - ylo) * (H - PAD_T - PAD_B)

    n = len(stats)
    span = (W - PAD_L - PAD_R) / max(n, 1)
    bw = min(36.0, span * 0.5)
    yticks = [(t, py(t)) for t in _ticks(ylo, yhi, 4)]
    out = [
        f'<svg viewBox="0 0 {W} {H}" width="{W}" height="{H}" role="img">',
        f'<rect width="{W}" height="{H}" fill="var(--surface-1)"/>',
        _axes(0, 1, ylo, yhi, xlab, ylab, [], yticks),
    ]
    for i, (label, s) in enumerate(stats):
        cx = PAD_L + span * (i + 0.5)
        out.append(
            f'<text x="{cx:.1f}" y="{H-PAD_B+16}" fill="var(--muted)" '
            f'font-size="11" text-anchor="middle">{html.escape(str(label)[:18])}</text>'
        )
        if s is None:
            continue
        lo_w, q1, med, q3, hi_w = s
        t = html.escape(
            f"{label}: median {med:.2f}, IQR [{q1:.2f}, {q3:.2f}]"
        )
        out.append(
            f'<g stroke="var(--series-1)" fill="none" stroke-width="2">'
            f'<line x1="{cx:.1f}" y1="{py(lo_w):.1f}" x2="{cx:.1f}" y2="{py(q1):.1f}"/>'
            f'<line x1="{cx:.1f}" y1="{py(q3):.1f}" x2="{cx:.1f}" y2="{py(hi_w):.1f}"/>'
            f'<rect x="{cx-bw/2:.1f}" y="{py(q3):.1f}" width="{bw:.1f}" '
            f'height="{max(py(q1)-py(q3), 1):.1f}" rx="4" '
            f'fill="var(--series-1)" fill-opacity="0.18"/>'
            f'<line x1="{cx-bw/2:.1f}" y1="{py(med):.1f}" x2="{cx+bw/2:.1f}" '
            f'y2="{py(med):.1f}"/><title>{t}</title></g>'
        )
    out.append("</svg>")
    return f'<div class="card">{"".join(out)}</div>'


def render_report(
    features,
    filenames: List[str],
    config: dict,
    areas: Optional[dict] = None,
    version: str = "0.1.0",
) -> str:
    """Assemble the full QC report HTML (runner.rs:1242-1802)."""
    c = features.columns
    n = len(features)
    target = c["label"] == 1
    q = c["spectrum_q"]

    # --- per-file overview table ---
    rows = []
    for fid, fname in enumerate(filenames):
        sel = c["file_id"] == fid
        n_psm = int(((q <= 0.01) & target & sel).sum())
        pep_q = c["peptide_q"]
        n_pep = int(((pep_q <= 0.01) & target & sel).sum())
        prot_q = c["protein_q"]
        n_prot = int(((prot_q <= 0.01) & target & sel).sum())
        dm = c["delta_mass"][sel & target]
        med_ppm = float(np.median(dm)) if dm.size else float("nan")
        rows.append(
            f"<tr><td>{html.escape(fname)}</td><td>{int(sel.sum())}</td>"
            f"<td>{n_psm}</td><td>{n_pep}</td><td>{n_prot}</td>"
            f"<td>{med_ppm:.2f}</td></tr>"
        )
    table = (
        '<table class="qc"><tr><th>file</th><th>PSMs reported</th>'
        "<th>PSMs at 1% FDR</th><th>peptides at 1% FDR</th>"
        "<th>proteins at 1% FDR</th><th>median mass error (ppm)</th></tr>"
        + "".join(rows)
        + "</table>"
    )

    # --- scoring QC ---
    ds = c["discriminant_score"].astype(np.float64)
    score_hist = svg_histogram(
        [
            ("target", "--series-1", ds[target]),
            ("decoy", "--series-2", ds[~target]),
        ],
        "discriminant score",
    )
    # PP plot: observed decoy fraction vs mean PEP, cumulated over
    # score-descending PSMs (calibration check)
    order = np.argsort(-ds, kind="stable")
    pep_sorted = np.power(10.0, c["posterior_error"][order].astype(np.float64))
    dec_sorted = (~target)[order].astype(np.float64)
    denom = np.arange(1, n + 1, dtype=np.float64)
    pp = svg_scatter(
        np.cumsum(pep_sorted) / denom,
        np.cumsum(dec_sorted) / denom,
        "mean posterior error (cumulative)",
        "decoy fraction (cumulative)",
        "calibration",
        identity_line=True,
    ) if n else ""
    q_hists = "".join(
        svg_histogram([(lbl, "--series-1", c[col][target])], lbl, bins=50)
        for lbl, col in (
            ("spectrum q-value", "spectrum_q"),
            ("peptide q-value", "peptide_q"),
            ("protein q-value", "protein_q"),
        )
    )

    # --- predicted properties (q <= 0.01 targets) ---
    conf = target & (q <= 0.01)
    rt_scatter = svg_scatter(
        c["aligned_rt"][conf], c["predicted_rt"][conf],
        "aligned RT", "predicted RT", "RT model", identity_line=True,
    )
    ims = c["ims"][conf]
    ims_scatter = ""
    if np.any(ims != 0.0):
        ims_scatter = svg_scatter(
            ims, c["predicted_ims"][conf],
            "measured 1/K0", "predicted 1/K0", "mobility model",
            identity_line=True,
        )

    # --- LFQ boxplot ---
    lfq_box = ""
    if areas:
        per_file = [[] for _ in filenames]
        for (pid, decoy), (peak, data) in areas.items():
            if decoy:
                continue
            for i, v in enumerate(data):
                if v > 0:
                    per_file[i].append(math.log10(v))
        lfq_box = svg_boxplot(
            list(zip(filenames, per_file)), "file", "log10 LFQ intensity"
        )

    cfg_pretty = html.escape(json.dumps(config, indent=2))
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8">
<title>sage_tpu QC report</title><style>{_CSS}</style></head>
<body class="viz-root">
<h1>sage_tpu search report</h1>
<p>version {html.escape(version)} &middot; {n} PSMs reported across
{len(filenames)} file(s).</p>
<h2>Results overview</h2>
{table}
{lfq_box}
<h2>Scoring quality control</h2>
<p>Higher discriminant scores should separate targets from decoys; the
calibration plot compares the model's posterior error against the
observed decoy fraction (closer to the diagonal is better).</p>
{score_hist}
{pp}
{q_hists}
<h2>Predicted properties</h2>
<p>Retention time (and ion mobility, when measured) for confident PSMs
(spectrum q &le; 0.01) against the linear model predictions.</p>
{rt_scatter}
{ims_scatter}
<h2>Configuration</h2>
<pre class="config">{cfg_pretty}</pre>
</body></html>
"""
