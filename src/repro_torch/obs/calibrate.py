"""Predicted-vs-measured calibration for the Engine's cost models (the
port's own copy of the JAX package's ``repro.obs.calibrate``: the same
arithmetic, so both packages price one structure in the same bytes).

The `auto` axes resolve through small analytic cost models
(``select_delivery``'s HBM-traffic model, ``select_backend``'s sync
bytes, ...) whose predictions were never checked against measured
reality — the feedback loop the ROADMAP's TPU-calibration item stalls
on.  This module closes it with pure host-side arithmetic:

* ``fused_traffic`` / ``reference_traffic`` — modeled HBM bytes of the
  two delivery lowerings for a BUILT layout (per degree class, so the
  measured side of ``Result.decision["measured"]["delivery"]`` reports
  actual bytes moved per class, not just a total);
* ``executed_supersteps`` — superstep pairs that did real work, from
  collected activity stats (the measured counterpart of ``max_iters``);
* ``delivery_calibration`` — per-regime predicted-vs-measured residuals
  (log2 ratio) over a table of measured regimes (the JAX package's
  ``bench_delivery``; ``chip_smoke.py``'s delivery grid), plus decision
  accuracy: did ``auto`` pick the measured winner?;
* ``decision_residuals`` — the same comparison for one enriched
  ``Result.decision``.

Residuals are in log2 space: ``residual_log2 = log2(pred / meas)``, so
0 is perfect, +1 means the model predicted 2x the measured ratio, and
the mean over regimes is a geometric-mean correction factor
(``suggested_model_scale``) the traffic model could fold in.
"""
from __future__ import annotations

import math

import numpy as np
import torch

ID_BYTES = 4.0  # int32 incidence ids


def reference_traffic(nnz: int, n_dst: int, width_bytes: float) -> float:
    """Modeled HBM bytes of one reference (gather -> mask ->
    segment-reduce) half-superstep: the ``[nnz, D]`` rows intermediate
    is written and re-read, plus src/dst id reads and the output —
    the JAX package's model, unchanged."""
    return float(nnz) * (3.0 * width_bytes + 2.0 * ID_BYTES) + (
        float(n_dst) * width_bytes
    )


def fused_traffic(layout, width_bytes: float) -> dict:
    """Modeled HBM bytes of one fused half-superstep over a BUILT
    degree-class layout, itemized per class.  Uses the layout's padded
    dims (``class_rows`` are array dims), so this is what the dense
    reduces actually stream — the measured side of the cost model's
    work-slot prediction."""
    width_bytes = float(width_bytes)
    per_class = [
        float(int(r) * int(k)) * (width_bytes + ID_BYTES)
        for r, k in zip(layout.class_rows, layout.class_widths)
    ]
    residual = float(layout.rem_len) * (width_bytes + ID_BYTES)
    output = float(layout.n_dst) * width_bytes
    return {
        "class_widths": [int(k) for k in layout.class_widths],
        "class_rows": [int(r) for r in layout.class_rows],
        "per_class_bytes": per_class,
        "residual_bytes": residual,
        "output_bytes": output,
        "total_bytes": float(sum(per_class)) + residual + output,
        "ell_slots": int(layout.ell_slots),
        "residual_lanes": int(layout.rem_len),
        "nnz": int(layout.nnz),
    }


def delivery_traffic_pair(layouts, width_bytes: float) -> dict:
    """Both delivery directions (v->he forward, he->v backward) of one
    superstep; ``layouts`` is the Engine's ``(fwd, bwd)`` pair."""
    fwd, bwd = layouts
    f, b = fused_traffic(fwd, width_bytes), fused_traffic(bwd, width_bytes)
    return {
        "fwd": f,
        "bwd": b,
        "total_bytes": f["total_bytes"] + b["total_bytes"],
        "reference_total_bytes": (
            reference_traffic(fwd.nnz, fwd.n_dst, width_bytes)
            + reference_traffic(bwd.nnz, bwd.n_dst, width_bytes)
        ),
    }


def executed_supersteps(superstep_stats, max_iters: int | None = None):
    """Superstep pairs that did real work, from collected activity
    stats ``(v_active, he_active)``.  Batched stats (leading query dim)
    report the slowest query — the pair count the batch actually ran."""
    if superstep_stats is None:
        return None
    v, he = (
        (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
        .astype(np.int64)
        for x in superstep_stats
    )
    while v.ndim > 1:
        v = v.max(axis=0)
    while he.ndim > 1:
        he = he.max(axis=0)
    n = int(((v + he) > 0).sum())
    return min(n, int(max_iters)) if max_iters is not None else n


def residual_log2(predicted: float, measured: float) -> float:
    """log2(pred / meas), clamped away from zero on both sides."""
    return math.log2(max(float(predicted), 1e-12)
                     / max(float(measured), 1e-12))


def delivery_calibration(regimes: dict) -> dict:
    """Predicted-vs-measured residuals for ``select_delivery``'s
    HBM-traffic model over measured regime records.

    Per regime: the model's predicted fused-vs-reference traffic ratio
    (``model_traffic_ratio``) against the measured speedup
    (``fused_speedup``), the log2 residual between them, and whether
    ``auto``'s pick matches the measured winner.  The summary's
    ``suggested_model_scale`` is the geometric-mean correction the
    traffic model would need to center its residuals — the number the
    ROADMAP's TPU-calibration item asks for, per platform."""
    per: dict[str, dict] = {}
    resids: list[float] = []
    agree = 0
    for name, r in regimes.items():
        pred = float(r["model_traffic_ratio"])
        meas = float(
            r["fused_speedup"]
            if r.get("fused_speedup") is not None
            else r["xla_s"] / r["fused_s"]
        )
        resid = residual_log2(pred, meas)
        measured_winner = "pallas_fused" if meas >= 1.0 else "xla"
        auto_pick = r.get("auto_picks")
        agrees = auto_pick == measured_winner
        agree += int(agrees)
        resids.append(resid)
        per[name] = {
            "predicted_ratio": pred,
            "measured_ratio": meas,
            "residual_log2": resid,
            "auto_picks": auto_pick,
            "measured_winner": measured_winner,
            "decision_agrees": agrees,
        }
    n = max(len(per), 1)
    summary = {
        "regimes": len(per),
        "mean_abs_residual_log2": (
            float(np.mean(np.abs(resids))) if resids else 0.0
        ),
        "max_abs_residual_log2": (
            float(np.max(np.abs(resids))) if resids else 0.0
        ),
        "decision_accuracy": agree / n,
        "suggested_model_scale": (
            float(2.0 ** (-np.mean(resids))) if resids else 1.0
        ),
    }
    return {"regimes": per, "summary": summary}


def decision_residuals(decision: dict) -> dict:
    """Per-axis predicted-vs-measured residuals for ONE enriched
    ``Result.decision`` (an ``Engine.run`` result; the ``measured``
    entry is added post-run).  Axes without both sides are omitted."""
    out: dict[str, dict] = {}
    measured = (decision or {}).get("measured") or {}

    dwhy = decision.get("delivery") or {}
    md = measured.get("delivery")
    if md is not None and dwhy.get("class_work_slots") is not None:
        predicted = float(dwhy["class_work_slots"])
        built = float(
            md["fwd"]["ell_slots"] + md["fwd"]["residual_lanes"]
            + md["bwd"]["ell_slots"] + md["bwd"]["residual_lanes"]
        )
        out["delivery"] = {
            "predicted_work_slots": predicted,
            "built_work_slots": built,
            "residual_log2": residual_log2(predicted, built),
        }

    supersteps = measured.get("supersteps")
    if supersteps is not None:
        budget = decision.get("max_iters") or measured.get("max_iters")
        out["supersteps"] = {
            "executed": int(supersteps),
            **({"budget": int(budget)} if budget else {}),
        }
    return out
