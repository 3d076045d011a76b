"""PDF map report (twin of :mod:`oisat_tpu.report`; reference
oisatgmi/report.py:13-210).

Same report content and layout — a title page followed by one map per
field, with the reference's per-gas color ranges and units — but built on
matplotlib's PdfPages instead of Basemap+fpdf (Basemap is deprecated and
fpdf is unavailable).  Every panel gets coastlines like the reference's
Basemap maps, drawn from the vendored polylines in
:mod:`oisat_tpu_torch.data` (survey-grade ``coastlines.npz`` when present —
see tools/make_coastlines.py — otherwise the built-in approximate set).

matplotlib is imported, with the Agg backend, inside the functions that draw:
the package imports where matplotlib is absent, and a call there raises
ImportError naming it.
"""

from __future__ import annotations

import datetime
import os

import numpy as np

__all__ = ["plotter", "report", "draw_coastlines"]

def _pyplot():
    """matplotlib.pyplot on the Agg backend (no display needed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


_UNIT_LABELS = {
    1: r"$[\times 10^{15} molec.cm^{-2}]$",
    2: "$[Unitless]$",
    3: "$[DU]$",
    4: r"$[\times 10^{18} molec.cm^{-2}]$",
    5: "$[ppmv]$",
    6: "$[ppbv]$",
    7: "$[mm]$",
}

# per-gas plot ranges (reference report.py:124-183)
_GAS_RANGES = {
    "HCHO": dict(vmin_vcd=0.0, vmax_vcd=20.0, vmax_error=15.0, vmin_incre=-5.0,
                 vmax_incre=5.0, unit=1, aux="AMF"),
    "NO2": dict(vmin_vcd=0.0, vmax_vcd=10.0, vmax_error=5.0, vmin_incre=-5.0,
                vmax_incre=5.0, unit=1, aux="AMF"),
    "O3": dict(vmin_vcd=200.0, vmax_vcd=500.0, vmax_error=30.0, vmin_incre=-20.0,
               vmax_incre=20.0, unit=3, aux="null"),
    "CO": dict(vmin_vcd=0.0, vmax_vcd=3.0, vmax_error=0.2, vmin_incre=-2.0,
               vmax_incre=2.0, unit=4, aux="xcol", scale=1e-3,
               unit_aux=5, vmin_aux=0.0, vmax_aux=0.15),
    "CH4": dict(vmin_vcd=1750.0, vmax_vcd=1900.0, vmax_error=20.0, vmin_incre=-40.0,
                vmax_incre=40.0, unit=6, aux="xcol",
                unit_aux=6, vmin_aux=1750.0, vmax_aux=1900.0),
    "H2O": dict(vmin_vcd=0.0, vmax_vcd=70.0, vmax_error=20.0, vmin_incre=-5.0,
                vmax_incre=5.0, unit=7, aux="null"),
}


def draw_coastlines(ax, lon_min, lon_max, lat_min, lat_max):
    """Overlay the vendored coastline polylines on one panel, clipped to
    the map extent (the reference drew every panel on a coastline Basemap,
    reference report.py:33-38)."""
    from oisat_tpu_torch.data import coastline_segments

    pad_x = 0.02 * max(lon_max - lon_min, 1e-9)
    pad_y = 0.02 * max(lat_max - lat_min, 1e-9)
    x0, x1 = lon_min - pad_x, lon_max + pad_x
    y0, y1 = lat_min - pad_y, lat_max + pad_y
    for seg in coastline_segments():
        # keep every EDGE whose bounding box touches the extent — a long
        # sparse edge can cross a small regional map with both endpoints
        # outside it (vertex-inside tests would drop the coastline there)
        ex0 = np.minimum(seg[:-1, 0], seg[1:, 0])
        ex1 = np.maximum(seg[:-1, 0], seg[1:, 0])
        ey0 = np.minimum(seg[:-1, 1], seg[1:, 1])
        ey1 = np.maximum(seg[:-1, 1], seg[1:, 1])
        edge = (ex1 >= x0) & (ex0 <= x1) & (ey1 >= y0) & (ey0 <= y1)
        if not edge.any():
            continue
        keep = np.zeros(len(seg), bool)
        keep[:-1] |= edge
        keep[1:] |= edge
        x = np.where(keep, seg[:, 0], np.nan)
        y = np.where(keep, seg[:, 1], np.nan)
        ax.plot(x, y, color="black", linewidth=0.8, solid_capstyle="round",
                zorder=3)
    ax.set_xlim(lon_min, lon_max)
    ax.set_ylim(lat_min, lat_max)


def plotter(X, Y, Z, ax, title: str, unit: int, vmin, vmax):
    """One map panel (reference report.py:13-59)."""
    from matplotlib.ticker import FormatStrFormatter

    plt = _pyplot()
    lon_min, lon_max = float(np.nanmin(X)), float(np.nanmax(X))
    lat_min, lat_max = float(np.nanmin(Y)), float(np.nanmax(Y))
    im = ax.imshow(np.asarray(Z, float), origin="lower",
                   extent=[lon_min, lon_max, lat_min, lat_max],
                   interpolation="nearest", aspect="auto", vmin=vmin, vmax=vmax,
                   cmap="rainbow")
    draw_coastlines(ax, lon_min, lon_max, lat_min, lat_max)
    ax.set_xlabel("Lon", fontsize=14)
    ax.set_ylabel("Lat", fontsize=14)
    ax.xaxis.set_major_formatter(FormatStrFormatter("%.1f"))
    ax.yaxis.set_major_formatter(FormatStrFormatter("%.1f"))
    cbar = plt.colorbar(im, ax=ax)
    cbar.set_label(_UNIT_LABELS.get(unit, ""), fontsize=12)
    ax.set_title(title, loc="left", fontweight="bold", fontsize=14)


def report(lon, lat, ctm_vcd_before, ctm_vcd_after, sat_vcd, sat_err, increment,
           averaging_kernel, error_OI, aux1, aux2, fname: str, ffolder: str,
           gasname: str):
    """Collate the 7-9 analysis maps into a landscape PDF (reference
    report.py:117-210).

    Deliberate deviation: pages follow the pipeline order (prior,
    posterior, observation, ...), not the reference's alphabetical
    sorted-glob order of its intermediate PNG files — same panels, same
    ranges/units, more readable sequence."""
    plt = _pyplot()
    from matplotlib.backends.backend_pdf import PdfPages

    cfg = _GAS_RANGES.get(gasname)
    if cfg is None:
        raise ValueError(f"no report ranges for gas {gasname!r}")
    scale = cfg.get("scale", 1.0)
    fields = [
        ("CTM VCD (prior)", ctm_vcd_before * scale, cfg["unit"], cfg["vmin_vcd"], cfg["vmax_vcd"]),
        ("CTM VCD (posterior)", ctm_vcd_after * scale, cfg["unit"], cfg["vmin_vcd"], cfg["vmax_vcd"]),
        ("Satellite Observation (Y)", sat_vcd * scale, cfg["unit"], cfg["vmin_vcd"], cfg["vmax_vcd"]),
        ("Satellite Error (So)", sat_err * scale, cfg["unit"], 0.0, cfg["vmax_error"]),
        ("Increment", increment * scale, cfg["unit"], cfg["vmin_incre"], cfg["vmax_incre"]),
        ("Averaging Kernels", averaging_kernel, 2, 0.0, 1.0),
        ("OI estimate error", error_OI * scale, cfg["unit"], 0.0, cfg["vmax_error"]),
    ]
    if cfg["aux"] == "AMF":
        fields += [("new AMF", aux1, 2, 0.0, 4.0), ("old AMF", aux2, 2, 0.0, 4.0)]
    elif cfg["aux"] == "xcol":
        fields += [
            ("X_col (SAT)", aux1, cfg["unit_aux"], cfg["vmin_aux"], cfg["vmax_aux"]),
            ("X_col (CTM-Prior)", aux2, cfg["unit_aux"], cfg["vmin_aux"], cfg["vmax_aux"]),
        ]

    os.makedirs(ffolder, exist_ok=True)
    pdf_path = os.path.join(ffolder, "OI_report_" + fname + ".pdf")
    with PdfPages(pdf_path) as pdf:
        # title page (reference topdf, report.py:92-104)
        fig = plt.figure(figsize=(11.69, 8.27))
        fig.text(0.5, 0.65, "The Optimal Interpolation Report generated by the OI-SAT tool "
                 "(PyTorch port)", ha="center", fontsize=18, fontweight="bold")
        fig.text(0.5, 0.5, "Created at: "
                 + datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
                 ha="center", fontsize=12)
        pdf.savefig(fig)
        plt.close(fig)
        for title, field, unit, vmin, vmax in fields:
            if np.size(field) <= 1:
                continue
            fig, ax = plt.subplots(figsize=(11.69, 8.27))
            plotter(lon, lat, field, ax, title, unit, vmin, vmax)
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)
    return pdf_path
