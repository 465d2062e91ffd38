"""Workflow introspection shared by the reporting surfaces (port of
``znicz_tpu/utils/introspect.py``): the web status page and any report
read the same numbers for the same workflow."""

from __future__ import annotations


def validation_metrics(workflow) -> dict[str, float]:
    """Real validation metrics only: the decision's ``min_validation_*``
    fields are untouched initial values when the loader has no
    validation split, and reporting those would fabricate a result."""
    from znicz_tpu_torch.loader.base import VALID
    decision = getattr(workflow, "decision", None)
    loader = getattr(workflow, "loader", None)
    if decision is None or loader is None or not loader.is_initialized \
            or not loader.class_lengths[VALID]:
        return {}
    out: dict[str, float] = {}
    for attr in ("min_validation_n_err_pt", "min_validation_mse"):
        value = getattr(decision, attr, None)
        if value is not None:
            out[attr] = float(value)
    return out


def slowest_units(workflow, n: int = 5) -> list[dict]:
    """The ``n`` units with the most cumulative host time."""
    rows = sorted(
        (u for u in workflow.units if u.run_count),
        key=lambda u: u.run_time_total, reverse=True)[:n]
    return [{"unit": u.name, "runs": u.run_count,
             "total_s": round(u.run_time_total, 4)} for u in rows]
