"""A/B run comparison and the regression gate — the port's copy of the
JAX package's ``obs/compare.py``.

``compare(base, cand)`` diffs two run documents and emits a
machine-readable verdict::

    {"metrics": {name: {"base": x, "cand": y, "rel_change": r,
                        "threshold": t, "verdict": "ok|regression|
                        improvement|missing"}},
     "regressions": [name, ...], "improvements": [...], "ok": bool}

Accepted document shapes (``extract_metrics`` normalizes; mixing
shapes is fine):

- an ``obs/aggregate.py`` run report (``kind: "run_report"``);
- a ``bench.py`` per-config row (``wall_clock_20ep_s``, ...);
- the ``bench.py`` final summary line (``metric``/``value``);
- ``BASELINE.json`` (its ``measured`` anchors);
- a ``BENCH_*.json`` capture of a bench run's stdout (``{"tail":
  "..."}``: its last JSON line is the bench final summary);
- an ``obs/history.py`` record (``kind: "bench_history"``) or the
  rolling-median baseline (``kind: "history_baseline"``).

Thresholds are RELATIVE and one-sided: wall/step-time may grow, or
throughput/MFU/accuracy/goodput shrink, by up to the threshold before
a metric counts as a regression.  ``dtx-obs compare`` (``obs/cli.py``)
exits 3 on a regression.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

# metric -> (direction, default relative threshold); "lower" = smaller
# is better (wall), "higher" = bigger is better (throughput)
GATE_METRICS: Dict[str, tuple] = {
    "wall_s": ("lower", 0.05),
    "examples_per_sec": ("higher", 0.05),
    "tokens_per_sec": ("higher", 0.05),
    "mfu": ("higher", 0.05),
    "step_time_p50_ms": ("lower", 0.05),
    "goodput_frac": ("higher", 0.05),
    "test_accuracy": ("higher", 0.02),
    # the bench's input-pipeline row: medians of short interleaved A/B
    # runs, noisier by nature, hence the wider default
    "blocking_step_ms": ("lower", 0.15),
    "prefetch_step_ms": ("lower", 0.15),
    "overlap_ratio": ("higher", 0.15),
    # the per-row headline MFUs and the MoE dispatch/expert breakdown
    # (short standalone component programs: the wider default)
    "transformer_wide_mfu": ("higher", 0.05),
    "transformer_wide_long_mfu": ("higher", 0.05),
    "moe_wide_mfu": ("higher", 0.05),
    "moe_dispatch_ms": ("lower", 0.15),
    "moe_expert_ms": ("lower", 0.15),
    # pipeline bubble fractions: analytic tick-table accounting, so any
    # upward move is a schedule regression (the tight threshold)
    "pp_bubble_frac_gpipe": ("lower", 0.01),
    "pp_bubble_frac_1f1b": ("lower", 0.01),
    "pp_bubble_frac_interleaved_v2": ("lower", 0.01),
    "pp_bubble_frac_interleaved_v4": ("lower", 0.01),
    # serving latency p99 and decode throughput from short measured
    # loops (wide thresholds), and the decode roofline fraction
    "serving_p99_ms": ("lower", 0.25),
    "serving_tok_s": ("higher", 0.25),
    "decode_hbm_frac": ("higher", 0.05),
    # multi-site local SGD: comm bytes per token is a closed form (any
    # upward move is an algorithm regression), the final cost measured
    "local_sgd_comm_bytes_per_token": ("lower", 0.01),
    "local_sgd_final_cost": ("lower", 0.25),
    # the quantization keys: closed forms, deterministic on every
    # backend, so the tight 1%
    "decode_kv_bytes_per_step_int8": ("lower", 0.01),
    "decode_kv_reduction_int8": ("higher", 0.01),
    "local_sgd_outer_quant_bytes_per_token": ("lower", 0.01),
    "local_sgd_outer_quant_reduction": ("higher", 0.01),
    # async checkpoints: the per-snapshot submit stall and the
    # with/without step-time ratio share a crowded host (wide default)
    "ckpt_stall_ms": ("lower", 0.25),
    "ckpt_overhead_ratio": ("lower", 0.25),
    # fail-open serving: the degraded workload's completed fraction is
    # a closed form (tight), the crash plan's p99 measured (wide)
    "serving_degraded_completed_frac": ("higher", 0.01),
    "serving_degraded_p99_ms": ("lower", 0.25),
    # span emission: a median of interleaved on/off tok/s ratios, ~1.0
    # by construction
    "trace_retained_tok_frac": ("higher", 0.01),
    # latency attribution: both ratios sit at ~1.0 by construction (the
    # waterfall partition is exact), so the tight 1% is absolute
    "waterfall_sum_to_wall_frac": ("higher", 0.01),
    "attribution_retained_tok_frac": ("higher", 0.01),
    # fleet failover: the analytic fleet's completed fraction (1.0 by
    # construction) and the measured failed-over p99
    "fleet_completed_frac": ("higher", 0.01),
    "fleet_failover_p99_ms": ("lower", 0.25),
    # workload replay: two-replay determinism (1.0 by construction) and
    # the capacity forecast against the measured saturation knee
    "replay_determinism_frac": ("higher", 0.01),
    "capacity_forecast_rel_err": ("lower", 0.25),
}

# the gate keys the bench's final summary line carries under their gate
# names verbatim
_SUMMARY_KEYS = (
    "transformer_wide_mfu", "transformer_wide_long_mfu", "moe_wide_mfu",
    "moe_dispatch_ms", "moe_expert_ms", "pp_bubble_frac_gpipe",
    "pp_bubble_frac_1f1b", "pp_bubble_frac_interleaved_v2",
    "pp_bubble_frac_interleaved_v4", "serving_p99_ms", "serving_tok_s",
    "decode_hbm_frac", "local_sgd_comm_bytes_per_token",
    "local_sgd_final_cost", "decode_kv_bytes_per_step_int8",
    "decode_kv_reduction_int8", "local_sgd_outer_quant_bytes_per_token",
    "local_sgd_outer_quant_reduction", "ckpt_stall_ms",
    "ckpt_overhead_ratio", "serving_degraded_completed_frac",
    "serving_degraded_p99_ms", "trace_retained_tok_frac",
    "waterfall_sum_to_wall_frac", "attribution_retained_tok_frac",
    "fleet_completed_frac", "fleet_failover_p99_ms",
    "replay_determinism_frac", "capacity_forecast_rel_err")

# bench rows recognised by a row-only key (the final summary carries
# the gate keys too and must fall through to its own branch): key ->
# the gate metrics the row carries under their own names
_ROW_KEYS = (
    ("sync_comm_bytes_per_token", (
        "local_sgd_comm_bytes_per_token", "local_sgd_final_cost",
        "local_sgd_outer_quant_bytes_per_token",
        "local_sgd_outer_quant_reduction")),
    ("decode_step_ms", ("decode_hbm_frac", "tokens_per_sec", "wall_s")),
    ("decode_kv_scale_bytes_per_step", (
        "decode_kv_bytes_per_step_int8", "decode_kv_reduction_int8")),
    ("ckpt_write_ms", ("ckpt_stall_ms", "ckpt_overhead_ratio")),
    ("continuous_ticks", ("serving_p99_ms", "serving_tok_s",
                          "decode_hbm_frac")),
    ("trace_on_tok_s", ("trace_retained_tok_frac",)),
    ("waterfall_requests", ("waterfall_sum_to_wall_frac",
                            "attribution_retained_tok_frac")),
    ("degraded_sim_ticks", ("serving_degraded_completed_frac",
                            "serving_degraded_p99_ms")),
    ("fleet_failover_requests", ("fleet_completed_frac",
                                 "fleet_failover_p99_ms")),
    ("workload_replay_requests", ("replay_determinism_frac",
                                  "capacity_forecast_rel_err")),
)


def _json_lines_reversed(text: str):
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                yield json.loads(line)
            except ValueError:
                continue


def _last_json_line(text: str) -> Optional[Dict[str, Any]]:
    return next(_json_lines_reversed(text), None)


def extract_metrics(doc: Dict[str, Any]) -> Dict[str, float]:
    """Normalize any accepted document shape to {gate metric: value}.
    Absent metrics are omitted — compare() only diffs the
    intersection."""
    out: Dict[str, float] = {}

    def put(name, val):
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[name] = float(val)

    if not isinstance(doc, dict):
        return out
    if isinstance(doc.get("tail"), str):        # BENCH_*.json capture
        # scan back past trailing lines that carry no gate metric (a
        # --gate verdict prints after the final summary)
        for inner in _json_lines_reversed(doc["tail"]):
            m = extract_metrics(inner)
            if m:
                return m
        return out
    if doc.get("kind") in ("bench_history", "history_baseline"):
        # the metrics dict is already the gate mapping; filtered to
        # known numeric keys so a doctored file smuggles in nothing
        for name, val in (doc.get("metrics") or {}).items():
            if name in GATE_METRICS:
                put(name, val)
        return out
    if doc.get("kind") == "run_report":         # aggregate.py report
        put("wall_s", doc.get("wall_s"))
        put("test_accuracy", doc.get("test_accuracy"))
        g = doc.get("goodput") or {}
        put("goodput_frac", g.get("goodput_frac"))
        st = doc.get("step_time") or {}
        put("step_time_p50_ms", st.get("p50_ms"))
        tp = doc.get("throughput") or {}
        put("examples_per_sec", tp.get("examples_per_sec_mean"))
        put("tokens_per_sec", tp.get("tokens_per_sec_last"))
        put("mfu", tp.get("mfu_mean"))
        return out
    if "measured" in doc and isinstance(doc["measured"], dict):
        # BASELINE.json: the recorded CPU anchors
        m = doc["measured"]
        put("wall_s", m.get("cpu_baseline_wall_clock_20ep_s"))
        put("test_accuracy", m.get("cpu_baseline_test_accuracy"))
        return out
    if "prefetch_step_ms" in doc:               # bench input-pipeline row
        for k in ("prefetch_step_ms", "blocking_step_ms", "overlap_ratio",
                  "test_accuracy"):
            put(k, doc.get(k))
        return out
    if "1f1b_bubble_fraction" in doc:           # bench pp_memory row
        for name in ("gpipe", "1f1b", "interleaved_v2",
                     "interleaved_v4"):
            put(f"pp_bubble_frac_{name}",
                doc.get(f"{name}_bubble_fraction"))
        return out
    for row_key, names in _ROW_KEYS:
        if row_key in doc:
            for k in names:
                put(k, doc.get(k))
            return out
    if "wall_clock_20ep_s" in doc:              # bench per-config row
        put("wall_s", doc.get("wall_clock_20ep_s"))
        put("examples_per_sec", doc.get("examples_per_sec"))
        put("mfu", doc.get("mfu"))
        put("test_accuracy", doc.get("test_accuracy"))
        g = doc.get("goodput_summary") or {}
        put("goodput_frac", g.get("goodput_frac"))
        return out
    if "metric" in doc and "value" in doc:      # bench final summary
        put("wall_s", doc.get("value"))
        put("mfu", doc.get("mfu"))
        put("test_accuracy", doc.get("learning_accuracy"))
        # the input-pipeline keys ride the final line under an
        # input_pipeline_ prefix
        put("blocking_step_ms", doc.get("input_pipeline_blocking_step_ms"))
        put("prefetch_step_ms", doc.get("input_pipeline_prefetch_step_ms"))
        put("overlap_ratio", doc.get("input_pipeline_overlap_ratio"))
        for k in _SUMMARY_KEYS:
            put(k, doc.get(k))
        return out
    # last resort: any directly-named gate metrics
    for name in GATE_METRICS:
        put(name, doc.get(name))
    return out


def compare(base: Dict[str, Any], cand: Dict[str, Any],
            thresholds: Optional[Dict[str, float]] = None,
            default_threshold: Optional[float] = None) -> Dict[str, Any]:
    """Diff two documents (any accepted shape). ``thresholds``
    overrides per metric; ``default_threshold`` overrides every
    metric's default at once."""
    b, c = extract_metrics(base), extract_metrics(cand)
    metrics: Dict[str, Any] = {}
    regressions, improvements = [], []
    for name, (direction, thr) in GATE_METRICS.items():
        if default_threshold is not None:
            thr = default_threshold
        if thresholds and name in thresholds:
            thr = thresholds[name]
        if name not in b or name not in c:
            if name in b or name in c:
                metrics[name] = {"base": b.get(name), "cand": c.get(name),
                                 "verdict": "missing"}
            continue
        bv, cv = b[name], c[name]
        if bv == 0 and cv != 0:
            # no finite relative change exists against a zero baseline:
            # reported without an Infinity (strict JSON) and not gated
            metrics[name] = {"base": bv, "cand": cv,
                             "rel_change": None, "threshold": thr,
                             "direction": direction,
                             "verdict": "incomparable"}
            continue
        rel = (cv - bv) / abs(bv) if bv else 0.0
        worse = rel > thr if direction == "lower" else rel < -thr
        better = rel < -thr if direction == "lower" else rel > thr
        verdict = ("regression" if worse
                   else "improvement" if better else "ok")
        metrics[name] = {"base": bv, "cand": cv,
                         "rel_change": round(rel, 6),
                         "threshold": thr, "direction": direction,
                         "verdict": verdict}
        if worse:
            regressions.append(name)
        elif better:
            improvements.append(name)
    return {
        "metrics": metrics,
        "compared": sorted(k for k, v in metrics.items()
                           if v.get("verdict") != "missing"),
        "regressions": regressions,
        "improvements": improvements,
        "ok": not regressions,
    }


def load_doc(path: str) -> Dict[str, Any]:
    """Read a comparison document from disk: a JSON file, or a logs
    directory (aggregated on the fly)."""
    if os.path.isdir(path):
        from .aggregate import aggregate

        return aggregate(path)
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        # a captured stdout file: handed over capture-shaped so
        # extract_metrics scans back to the newest metric-bearing line
        if _last_json_line(text) is None:
            raise ValueError(f"{path}: neither JSON nor a text capture "
                             f"with a JSON tail line")
        return {"tail": text}
