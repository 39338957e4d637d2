"""Run stability digest, a copy of `locate_tpu/utils/digest.py`: one
self-contained summary of a training trajectory's health — grad-norm
envelope + spikes, overflowed/non-finite metric counts, guard events
(non-finite skips and grad_norm_limit skips), logit split, and best-rFID
lag. The train loop prints it at the end of every run, aborted ones
included."""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional


def load_metrics_jsonl(path: str) -> List[dict]:
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def _finite(v) -> bool:
    return v is not None and isinstance(v, (int, float)) and math.isfinite(v)


def _pct(xs: List[float], q: float) -> float:
    """Percentile without numpy (the loop prints this at end of every
    run; keep it dependency-light). Linear interpolation, like
    np.percentile's default."""
    s = sorted(xs)
    if not s:
        return float("nan")
    pos = (len(s) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def stability_digest(rows: List[dict],
                     spike_factor: float = 100.0) -> Optional[Dict]:
    """Compute the digest from metrics.jsonl rows. Returns None when the
    run has no loss rows (nothing to summarize)."""
    losses = [r for r in rows if "d_loss" in r]
    evals = [r for r in rows if "eval_rfid" in r]
    if not losses:
        return None
    d: Dict = {"steps_logged": len(losses),
               "last_step": losses[-1].get("step")}

    norms = {}
    for key in ("d_grad_norm", "g_grad_norm"):
        vals = [(r.get("step"), r.get(key)) for r in losses if key in r]
        finite = [(s, v) for s, v in vals if _finite(v)]
        overflowed = len(vals) - len(finite)
        if not finite:
            norms[key] = {"overflowed_logged": overflowed}
            continue
        xs = [v for _, v in finite]
        med = _pct(xs, 50.0)
        spikes = [s for s, v in finite
                  if med > 0 and v > spike_factor * med]
        norms[key] = {
            "median": med, "p95": _pct(xs, 95.0), "max": max(xs),
            "spike_steps": spikes, "overflowed_logged": overflowed,
        }
    d["grad_norms"] = norms

    # Guard events: counters are cumulative running state -> read last.
    last = losses[-1]
    guards = {}
    for key in ("d_nonfinite_streak", "g_nonfinite_streak",
                "d_grad_limit_count", "g_grad_limit_count",
                "d_grad_limit_streak", "g_grad_limit_streak"):
        if key in last and last[key] is not None:
            guards[key] = int(last[key])
    d["guards"] = guards

    # Logit split: a healthy GAN keeps real/fake separated; both pinned
    # near 0 with g_loss ~ ln2 is the dead-D plateau signature. "Dead"
    # means DIED — the run must have shown a real split earlier (peak
    # > 1.0), or a fresh few-step run would be flagged at init.
    tail = losses[-max(1, len(losses) // 10):]
    if all("real_logits" in r for r in tail):
        rl = [r["real_logits"] for r in tail if _finite(r["real_logits"])]
        fl = [r["fake_logits"] for r in tail if _finite(r["fake_logits"])]
        all_splits = [
            abs(r["real_logits"] - r["fake_logits"]) for r in losses
            if _finite(r.get("real_logits")) and _finite(r.get("fake_logits"))
        ]
        if rl and fl:
            split = _pct([abs(a - b) for a, b in zip(rl, fl)], 50.0)
            peak = max(all_splits) if all_splits else 0.0
            d["logits_tail"] = {
                "real_median": _pct(rl, 50.0),
                "fake_median": _pct(fl, 50.0),
                "split_median": split,
                "peak_split": peak,
                "dead_d": bool(split < 0.1 and peak > 1.0),
            }

    if evals:
        best = min(evals, key=lambda r: r["eval_rfid"])
        d["eval"] = {
            "n_evals": len(evals),
            "best_rfid": best["eval_rfid"],
            "best_step": best["step"],
            "final_rfid": evals[-1]["eval_rfid"],
            "final_step": evals[-1]["step"],
            "evals_since_best": sum(
                1 for r in evals if r["step"] > best["step"]
            ),
        }
    return d


def format_digest(d: Optional[Dict]) -> List[str]:
    """Digest -> human-readable lines (markdown-compatible bullets)."""
    if not d:
        return ["(no loss rows logged — nothing to digest)"]
    lines = []
    for key, n in d.get("grad_norms", {}).items():
        if "median" not in n:
            lines.append(f"- {key}: all {n['overflowed_logged']} logged "
                         "values non-finite")
            continue
        spikes = n["spike_steps"]
        msg = (f"- {key}: median {n['median']:.3g}, p95 {n['p95']:.3g}, "
               f"max {n['max']:.3g}; spikes >100x median: {len(spikes)}")
        if spikes:
            msg += f" (first at step {spikes[0]})"
        if n["overflowed_logged"]:
            msg += f"; NON-FINITE metric values logged: {n['overflowed_logged']}"
        lines.append(msg)
    g = d.get("guards", {})
    nf = max(g.get("d_nonfinite_streak", 0), g.get("g_nonfinite_streak", 0))
    lim = g.get("d_grad_limit_count", 0) + g.get("g_grad_limit_count", 0)
    if "d_grad_limit_count" in g or "g_grad_limit_count" in g:
        lines.append(
            f"- grad_norm_limit skips: {lim} total "
            f"(final streak d={g.get('d_grad_limit_streak', 0)} "
            f"g={g.get('g_grad_limit_streak', 0)})")
    if "d_nonfinite_streak" in g:
        lines.append(f"- non-finite skip streak at end: {nf}")
    lt = d.get("logits_tail")
    if lt:
        lines.append(
            f"- logit split (last 10% of run): real {lt['real_median']:.3f}"
            f" / fake {lt['fake_median']:.3f}, |split| {lt['split_median']:.3f}"
            + (" — DEAD DISCRIMINATOR (split < 0.1)" if lt["dead_d"] else ""))
    ev = d.get("eval")
    if ev:
        msg = (f"- best rFID {ev['best_rfid']:.2f} at step {ev['best_step']}"
               f" (final {ev['final_rfid']:.2f} at {ev['final_step']})")
        if ev["evals_since_best"] >= 5:
            msg += (f" — REGRESSING: no improvement for "
                    f"{ev['evals_since_best']} evals")
        lines.append(msg)
    return lines
