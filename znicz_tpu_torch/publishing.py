"""Publishing: the post-training report (port of
``znicz_tpu/publishing.py``).

After a training run the :class:`Publisher` unit renders what ran and
how well: the model's layers, the config, the convergence metrics, the
slowest units and the plots.  The backends are the reference's:
Markdown, and self-contained HTML with the plot PNGs embedded base64
inline, plus the report's data as JSON.  :func:`render_markdown` and
:func:`render_html` are the reference's, so one report dict renders to
the same strings in both packages.

The report reads the trained workflow on the host: a layer's parameter
count from its tensors' shapes, the metrics from the decision
(:mod:`~znicz_tpu_torch.utils.introspect`), the plots after
:func:`~znicz_tpu_torch.graphics.flush_server` has drawn everything
submitted.  The Publisher fires once, when the decision raises
``complete`` (``StandardWorkflow.link_publisher``), under ``run`` and
``run_chunked`` alike.
"""

from __future__ import annotations

import base64
import datetime
import glob
import html
import json
import os

import numpy as np

from znicz_tpu_torch.units import Unit
from znicz_tpu_torch.utils.config import root
from znicz_tpu_torch.utils.introspect import slowest_units, validation_metrics


def _layer_rows(workflow) -> list[dict]:
    rows = []
    for unit in getattr(workflow, "forwards", []):
        # shapes, not values: no read back from the device
        n_params = sum(
            int(np.prod(tuple(param.shape)))
            for attr in getattr(unit, "EXPORT_PARAMS", ("weights", "bias"))
            if (param := getattr(unit, attr, None)) is not None)
        shape = getattr(unit, "output_shape", None)
        rows.append({
            "name": unit.name,
            "type": type(unit).__name__,
            "output_shape": tuple(shape) if shape is not None else (),
            "parameters": n_params,
        })
    return rows


_METRIC_LABELS = {
    "min_validation_n_err_pt": "best validation error %",
    "min_validation_mse": "best validation MSE",
}


def _metric_rows(workflow) -> dict:
    out: dict = {}
    loader = getattr(workflow, "loader", None)
    if loader is not None:
        out["epochs"] = int(loader.epoch_number)
    for attr, value in validation_metrics(workflow).items():
        out[_METRIC_LABELS.get(attr, attr)] = value
    return out


def gather_report(workflow) -> dict:
    """Everything a report renders, as plain data (also the json
    side-output — scripts consume it)."""
    timing = slowest_units(workflow, n=10)
    # plots: only THIS workflow's plotter outputs (the plots dir is
    # shared across runs and samples), and only after the async render
    # thread has drawn everything submitted — an unfinished flush
    # means a PNG could still be mid-write, so embed nothing then
    from znicz_tpu_torch import graphics
    flushed = graphics.flush_server()
    if not flushed:
        import logging
        logging.getLogger("znicz_tpu_torch.publishing").warning(
            "graphics flush timed out — report omits plots rather "
            "than embed mid-write PNGs")
    plots: list[str] = []
    if flushed:
        plots_dir = str(root.common.dirs.plots)
        unit_names = {u.name for u in workflow.units}
        started = getattr(workflow, "run_started_at", 0.0)
        plots = sorted(
            p for p in glob.glob(os.path.join(plots_dir, "*.png"))
            if os.path.splitext(os.path.basename(p))[0] in unit_names
            and os.path.getmtime(p) >= started - 1.0)
    snap = getattr(workflow, "snapshotter", None)
    return {
        "title": workflow.name,
        "generated": datetime.datetime.now().isoformat(
            sep=" ", timespec="seconds"),
        "metrics": _metric_rows(workflow),
        "layers": _layer_rows(workflow),
        "timing": timing,
        "plots": plots,
        "snapshot": snap.destination if snap is not None else None,
        "config": root.get(workflow.name).as_dict()
        if workflow.name in root else {},
    }


def render_markdown(report: dict) -> str:
    lines = [f"# Training report: {report['title']}",
             "", f"*Generated {report['generated']}*", ""]
    if report["metrics"]:
        lines += ["## Results", ""]
        for key, value in report["metrics"].items():
            lines.append(f"- **{key}**: {value}")
        lines.append("")
    if report["layers"]:
        lines += ["## Model", "",
                  "| layer | type | output shape | parameters |",
                  "|---|---|---|---|"]
        for row in report["layers"]:
            lines.append(
                f"| {row['name']} | {row['type']} | "
                f"{row['output_shape']} | {row['parameters']:,} |")
        total = sum(r["parameters"] for r in report["layers"])
        lines += ["", f"Total parameters: **{total:,}**", ""]
    if report["config"]:
        lines += ["## Configuration", "", "```json",
                  json.dumps(report["config"], indent=2, default=str),
                  "```", ""]
    if report["timing"]:
        lines += ["## Slowest units", "",
                  "| unit | runs | total s |", "|---|---|---|"]
        for row in report["timing"]:
            lines.append(f"| {row['unit']} | {row['runs']} | "
                         f"{row['total_s']} |")
        lines.append("")
    if report["snapshot"]:
        lines += [f"Best snapshot: `{report['snapshot']}`", ""]
    if report["plots"]:
        lines += ["## Plots", ""]
        lines += [f"![{os.path.basename(p)}]({p})" for p in report["plots"]]
        lines.append("")
    return "\n".join(lines)


def render_html(report: dict) -> str:
    """Self-contained HTML: plots embedded base64 inline."""
    md_body = []
    md_body.append(f"<h1>Training report: "
                   f"{html.escape(report['title'])}</h1>")
    md_body.append(f"<p><em>Generated "
                   f"{html.escape(report['generated'])}</em></p>")
    if report["metrics"]:
        md_body.append("<h2>Results</h2><ul>")
        for key, value in report["metrics"].items():
            md_body.append(f"<li><b>{html.escape(str(key))}</b>: "
                           f"{html.escape(str(value))}</li>")
        md_body.append("</ul>")
    if report["layers"]:
        md_body.append("<h2>Model</h2><table border=1 "
                       "cellpadding=4><tr><th>layer</th><th>type</th>"
                       "<th>output shape</th><th>parameters</th></tr>")
        for row in report["layers"]:
            md_body.append(
                f"<tr><td>{html.escape(row['name'])}</td>"
                f"<td>{html.escape(row['type'])}</td>"
                f"<td>{html.escape(str(row['output_shape']))}</td>"
                f"<td>{row['parameters']:,}</td></tr>")
        md_body.append("</table>")
    if report["config"]:
        md_body.append(
            "<h2>Configuration</h2><pre>"
            + html.escape(json.dumps(report["config"], indent=2,
                                     default=str)) + "</pre>")
    if report["timing"]:
        md_body.append("<h2>Slowest units</h2><table border=1 "
                       "cellpadding=4><tr><th>unit</th><th>runs</th>"
                       "<th>total s</th></tr>")
        for row in report["timing"]:
            md_body.append(
                f"<tr><td>{html.escape(row['unit'])}</td>"
                f"<td>{row['runs']}</td><td>{row['total_s']}</td></tr>")
        md_body.append("</table>")
    if report["snapshot"]:
        md_body.append(
            f"<p>Best snapshot: <code>"
            f"{html.escape(str(report['snapshot']))}</code></p>")
    for p in report["plots"]:
        try:
            with open(p, "rb") as f:
                data = base64.b64encode(f.read()).decode()
            md_body.append(
                f"<h3>{html.escape(os.path.basename(p))}</h3>"
                f'<img src="data:image/png;base64,{data}" '
                f'style="max-width:720px">')
        except OSError:
            continue
    body = "\n".join(md_body)
    return (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(report['title'])}</title></head>"
            f"<body>{body}</body></html>")


class Publisher(Unit):
    """The end-of-training report unit.

    Wired after the decision with ``gate_skip`` following ``not
    decision.complete`` (``StandardWorkflow.link_publisher``), it fires
    once, when training finishes."""

    KNOWN_FORMATS = ("md", "html", "json")

    def __init__(self, workflow, name: str | None = None,
                 out_dir: str | None = None,
                 formats: tuple = ("md", "html", "json"),
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.out_dir = out_dir
        self.formats = tuple(formats)
        # fail at wiring time, not after hours of training
        unknown = [f for f in self.formats if f not in self.KNOWN_FORMATS]
        if unknown:
            raise ValueError(f"unknown report format(s) {unknown} "
                             f"(have {self.KNOWN_FORMATS})")
        self.destinations: list[str] = []

    def run(self) -> None:
        wf = self.workflow
        out_dir = self.out_dir or str(root.common.dirs.cache)
        os.makedirs(out_dir, exist_ok=True)
        report = gather_report(wf)
        base = os.path.join(out_dir, f"{wf.name}_report")
        self.destinations = []
        for fmt in self.formats:
            path = f"{base}.{fmt}"
            if fmt == "md":
                content = render_markdown(report)
            elif fmt == "html":
                content = render_html(report)
            else:  # "json" — formats validated in __init__
                content = json.dumps(report, indent=2, default=str)
            with open(path, "w") as f:
                f.write(content)
            self.destinations.append(path)
        self.info("report → %s", ", ".join(self.destinations))
