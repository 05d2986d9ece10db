"""The decision-log schema — the port's copy of what
``tools/check_decisions_schema.py`` checks (``obs/provenance.DecisionLog``),
for the drills of the package (``resilience/fleet_drill.py``), which run
where ``tools/`` is not on the path.

The decision log is the audit trail ``why`` walks, so its integrity
contract is stricter than the event log's:

- every line parses as a JSON object with integer ``seq``, numeric
  ``ts``, and a ``kind`` from the documented decision vocabulary;
- ``seq`` is strictly increasing down the file (the append-only
  guarantee restarts must preserve);
- every ``parent_seq`` resolves to an EARLIER record in the log (a
  dangling parent means a causal chain that cannot be reconstructed);
- when a record carries a cost ``breakdown``, its additive components
  sum to the breakdown's ``total_ms`` within float tolerance (the
  attribution invariant ``diff`` relies on).
"""
from __future__ import annotations

import json
from pathlib import Path

from metis_tpu_torch.obs.provenance import DECISION_KINDS

# Risk-posture vocabulary a record's ``detail.ranking`` may carry
# (uncertainty layer, cost/uncertainty.py)
RANKING_KINDS = ("point", "quantile", "cvar")

# |sum(components) - total_ms| tolerance: breakdowns round-trip through
# JSON with per-component rounding, so exact equality is too strict
SUM_TOL_MS = 1e-3


def validate_decisions(records: list[dict]) -> list[str]:
    """Problems (empty = valid) for already-parsed decision dicts,
    oldest first."""
    problems: list[str] = []
    seen_seqs: set[int] = set()
    last_seq: int | None = None
    for i, rec in enumerate(records, 1):
        where = f"record {i}"
        if not isinstance(rec, dict):
            problems.append(f"{where}: not a JSON object")
            continue
        seq = rec.get("seq")
        if not isinstance(seq, int):
            problems.append(f"{where}: missing/non-integer 'seq'")
            continue
        where = f"record {i} (seq {seq})"
        if not isinstance(rec.get("ts"), (int, float)):
            problems.append(f"{where}: missing/non-numeric 'ts'")
        kind = rec.get("kind")
        if not isinstance(kind, str):
            problems.append(f"{where}: missing/non-string 'kind'")
        elif kind not in DECISION_KINDS:
            problems.append(f"{where}: unknown decision kind {kind!r}")
        if last_seq is not None and seq <= last_seq:
            problems.append(
                f"{where}: seq not strictly increasing "
                f"(previous was {last_seq})")
        parent = rec.get("parent_seq")
        if parent is not None:
            if not isinstance(parent, int):
                problems.append(
                    f"{where}: non-integer parent_seq {parent!r}")
            elif parent not in seen_seqs:
                problems.append(
                    f"{where}: parent_seq {parent} does not resolve to "
                    "an earlier record")
        bd = rec.get("breakdown")
        if bd is not None:
            if not isinstance(bd, dict):
                problems.append(f"{where}: breakdown is not an object")
            else:
                comps = bd.get("components")
                total = bd.get("total_ms")
                if not isinstance(comps, dict) \
                        or not isinstance(total, (int, float)):
                    problems.append(
                        f"{where}: breakdown needs 'components' object "
                        "and numeric 'total_ms'")
                else:
                    s = sum(float(v) for v in comps.values())
                    if abs(s - float(total)) > SUM_TOL_MS:
                        problems.append(
                            f"{where}: breakdown components sum to "
                            f"{s:.6f} ms but total_ms is {total:.6f} "
                            "(additivity violated)")
        detail = rec.get("detail")
        if isinstance(detail, dict):
            # risk-posture annotation (uncertainty layer): a bounded
            # vocabulary + knob ranges, so `metis-tpu why` can always
            # explain how a served plan was ranked
            ranking = detail.get("ranking")
            if ranking is not None and ranking not in RANKING_KINDS:
                problems.append(
                    f"{where}: unknown detail.ranking {ranking!r}")
            for knob in ("risk_quantile", "cvar_alpha"):
                v = detail.get(knob)
                if v is None:
                    continue
                if not isinstance(v, (int, float)) or not 0.5 <= v < 1.0:
                    problems.append(
                        f"{where}: detail.{knob} must be numeric in "
                        f"[0.5, 1), got {v!r}")
        seen_seqs.add(seq)
        last_seq = seq
    return problems


def validate_file(path: str | Path) -> tuple[int, list[str]]:
    """(num_records, problems) for one decision JSONL file; unparseable
    lines are problems, not crashes."""
    records: list[dict] = []
    problems: list[str] = []
    try:
        lines = Path(path).read_text().splitlines()
    except OSError as e:
        return 0, [f"cannot read {path}: {e}"]
    for lineno, line in enumerate(lines, 1):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as e:
            problems.append(f"line {lineno}: invalid JSON ({e.msg})")
    problems.extend(validate_decisions(records))
    return len(records), problems
