"""Capacity forecasting: workload shape + service model -> QPS — the
port's copy of the JAX package's ``obs/capacity.py``.

Where ``obs/queueing.py`` explains a past stream, this module answers
the planning question: given a captured WORKLOAD's traffic shape, how
many requests a second can one replica sustain, and how many replicas
does the offered load need?  The model is closed-form:

- a replica's decode budget is ``service_tok_s`` generated tokens a
  second: measured (an unloaded replay's ``tokens_total / wall_s``) or
  the roofline bound ``roofline_decode_tok_s`` (the card's HBM bytes/s
  over ``obs/flops.decode_bytes_per_step``, times the batch);
- one request costs its mean decode tokens (prefill is amortized into
  the measured rate), so ``sustainable_qps = service_tok_s *
  utilization_target / mean_new_tokens``;
- ``required_replicas = ceil(offered_qps / sustainable_qps)``.

``verdict`` holds a measured saturation knee to the forecast:
``dtx-obs capacity --measured-qps`` exits 3 when measurement falls
short of the forecast beyond tolerance.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

from . import flops as flops_lib
from .schema import SCHEMA_VERSION

# the fraction of the service budget a forecast plans to (at 100%
# Little's law says the backlog diverges)
UTILIZATION_TARGET = 0.8

DEFAULT_TOLERANCE = 0.25


def workload_shape(doc: Dict[str, Any]) -> Dict[str, float]:
    """The forecast's inputs off a WORKLOAD document: offered rate and
    mean request shape."""
    reqs = doc["requests"]
    n = max(len(reqs), 1)
    dur = max(float(doc.get("duration_s") or 0.0), 1e-9)
    return {
        "offered_qps": round(len(reqs) / dur, 6),
        "mean_prompt_len": round(
            sum(int(r["prompt_len"]) for r in reqs) / n, 3),
        "mean_new_tokens": round(
            sum(int(r["max_new_tokens"]) for r in reqs) / n, 3),
    }


def roofline_decode_tok_s(spec, batch: int, kv_len: float,
                          device=None,
                          kv_dtype_bytes: Optional[float] = None
                          ) -> Optional[float]:
    """The decode-token ceiling one replica's HBM allows: peak bytes/s
    over the analytic bytes a step, times the batch one step serves.
    None where the peak is unknown (the CPU, an unnamed card): callers
    fall back to a measured rate, never a made-up one."""
    peak = flops_lib.chip_peak_hbm_bytes(device)
    if peak is None:
        return None
    bytes_per_step = flops_lib.decode_bytes_per_step(
        spec, batch, kv_len, kv_dtype_bytes=kv_dtype_bytes)
    if bytes_per_step <= 0:
        return None
    return peak / bytes_per_step * max(int(batch), 1)


def forecast(doc: Dict[str, Any], service_tok_s: float,
             utilization_target: float = UTILIZATION_TARGET
             ) -> Dict[str, Any]:
    """The closed-form capacity document for one workload against one
    replica's service rate."""
    if service_tok_s <= 0:
        raise ValueError(
            f"service_tok_s={service_tok_s} must be > 0")
    if not 0 < utilization_target <= 1:
        raise ValueError(f"utilization_target={utilization_target} "
                         f"must be in (0, 1]")
    shape = workload_shape(doc)
    sustainable = (service_tok_s * utilization_target
                   / max(shape["mean_new_tokens"], 1e-9))
    rho = shape["offered_qps"] / max(sustainable, 1e-9)
    return {
        "v": SCHEMA_VERSION,
        "kind": "capacity",
        "generated_t": time.time(),
        "workload_id": doc["workload_id"],
        "n_requests": int(doc["n_requests"]),
        "offered_qps": shape["offered_qps"],
        "mean_prompt_len": shape["mean_prompt_len"],
        "mean_new_tokens": shape["mean_new_tokens"],
        "service_tok_s": round(float(service_tok_s), 6),
        "utilization_target": float(utilization_target),
        "sustainable_qps": round(sustainable, 6),
        "utilization": round(rho * utilization_target, 6),
        "required_replicas": int(math.ceil(
            shape["offered_qps"] / max(sustainable, 1e-9))),
    }


def verdict(forecast_qps: float, measured_qps: float,
            tolerance: float = DEFAULT_TOLERANCE) -> Dict[str, Any]:
    """Forecast vs measurement: ``rel_err`` is the gated
    ``capacity_forecast_rel_err``; ``ok`` is False exactly when the
    measured capacity falls SHORT of the forecast beyond tolerance
    (beating the forecast is headroom, but still counts toward
    rel_err)."""
    if forecast_qps <= 0:
        raise ValueError(f"forecast_qps={forecast_qps} must be > 0")
    rel_err = abs(measured_qps - forecast_qps) / forecast_qps
    return {
        "forecast_qps": round(float(forecast_qps), 6),
        "measured_qps": round(float(measured_qps), 6),
        "rel_err": round(rel_err, 6),
        "tolerance": float(tolerance),
        "ok": measured_qps >= forecast_qps * (1.0 - tolerance),
    }
