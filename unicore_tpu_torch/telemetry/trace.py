"""``unicore-tpu-torch-trace`` (counterpart of
``unicore_tpu/telemetry/trace.py``): merge per-process event journals into
one run timeline.  Standard library only, so it runs wherever the journals
can be copied to; on the same journals its output is the JAX package's
``unicore-tpu-trace`` output.

Input: a telemetry directory (or explicit ``events_rank*.jsonl`` files)
written by :mod:`unicore_tpu_torch.telemetry.journal`.  Output:

* a **merged, causally-ordered timeline** printed to stdout (one line
  per event, prefixed with the corrected cross-host time and rank);
* optionally (``--out``) a **Chrome-trace / Perfetto JSON** file whose
  slices are the sampled step spans (one track per rank x phase) and
  whose instants are every other event;
* a **post-mortem summary**: verdicts, agreed stops, rewinds,
  checkpoint saves/fallbacks/loads, membership-epoch transitions, shed
  totals -- e.g. ``rank 0 SENTINEL REWIND at update 12 -> snapshot
  @update 10``.

Cross-host clock correction: hosts' ``wall`` clocks skew, but within one
attempt the trainer's update counter is a shared logical clock -- every
host passes update U once.  The merger pairs each rank's update-carrying
events with the reference rank's wall time for the same (attempt,
update) and subtracts the per-rank median offset (per RANK, never across
attempts: an elastic restart replays updates, and pairing across
attempts would read the outage gap as skew).  A rank sharing no updates
with the reference (a serve journal) keeps raw wall time.  Ordering is
then (corrected time, update, rank) -- deterministic under ties.
"""

import argparse
import glob
import json
import logging
import os
import sys
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional

logger = logging.getLogger(__name__)

#: envelope keys every journal record carries (schema contract)
ENVELOPE_KEYS = (
    "run_id", "attempt", "rank", "membership_epoch", "update", "mono",
    "wall", "kind",
)


def find_journals(path: str) -> List[str]:
    """Journal files under ``path``: the file itself, ``events_rank*``
    in the directory, or in a ``telemetry/`` subdirectory of it."""
    if os.path.isfile(path):
        return [path]
    for base in (path, os.path.join(path, "telemetry")):
        hits = sorted(glob.glob(os.path.join(base, "events_rank*.jsonl")))
        if hits:
            return hits
    return []


def load_journal(path: str) -> List[Dict[str, Any]]:
    """Parse one journal; malformed lines are counted and skipped (a
    host killed mid-write leaves at most one torn tail line)."""
    records = []
    bad = 0
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                bad += 1
                continue
            if isinstance(rec, dict) and "kind" in rec:
                rec.setdefault("_file", os.path.basename(path))
                records.append(rec)
    if bad:
        logger.warning(f"{path}: skipped {bad} unparseable line(s)")
    return records


def clock_offsets(records: List[Dict[str, Any]]) -> Dict[int, float]:
    """Per-RANK wall-clock offsets against a reference rank.

    Skew is a property of the HOST (its clock), not of the attempt — and
    an elastic restart REPLAYS updates, so pairing an attempt-0 anchor
    with attempt-1's replay of the same update would read the outage gap
    as clock skew and shift a whole pre-crash stream past the restart
    (misordering the verdict after the resume).  Anchors are therefore
    paired only WITHIN one attempt: for each attempt, each rank's first
    wall time per update is compared against the reference rank's wall
    for the same (attempt, update); the per-rank offset is the median
    over all such pairs.  One offset per rank then also corrects that
    host's anchorless streams (its supervisor journal shares the same
    clock)."""
    # anchors[attempt][rank][update] = first wall seen
    anchors: Dict[int, Dict[int, Dict[int, float]]] = defaultdict(
        lambda: defaultdict(dict)
    )
    for rec in records:
        upd = rec.get("update")
        rank = rec.get("rank")
        if (
            isinstance(upd, int) and upd >= 0 and "wall" in rec
            and isinstance(rank, int)
        ):
            anchors[rec.get("attempt", 0)][rank].setdefault(
                upd, rec["wall"]
            )
    if not anchors:
        return {}
    totals: Dict[int, int] = defaultdict(int)
    for by_rank in anchors.values():
        for rank, table in by_rank.items():
            totals[rank] += len(table)
    ref_rank = max(totals, key=lambda r: totals[r])
    deltas_by_rank: Dict[int, List[float]] = defaultdict(list)
    for by_rank in anchors.values():
        ref = by_rank.get(ref_rank)
        if not ref:
            continue
        for rank, table in by_rank.items():
            if rank == ref_rank:
                continue
            deltas_by_rank[rank].extend(
                table[u] - ref[u] for u in table.keys() & ref.keys()
            )
    offsets: Dict[int, float] = {ref_rank: 0.0}
    for rank, deltas in deltas_by_rank.items():
        deltas.sort()
        offsets[rank] = deltas[len(deltas) // 2]
    return offsets


def merge(records: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One causally-ordered timeline: every record gains a ``_t`` field
    (clock-corrected wall seconds) and the list is sorted by
    (_t, update, rank)."""
    records = list(records)
    offsets = clock_offsets(records)
    for rec in records:
        off = offsets.get(rec.get("rank"), 0.0)
        rec["_t"] = float(rec.get("wall", 0.0)) - off
    records.sort(
        key=lambda r: (
            r["_t"],
            r["update"] if isinstance(r.get("update"), int) else -1,
            r.get("rank", -1),
        )
    )
    return records


# ---------------------------------------------------------------------------
# Chrome-trace (Perfetto) export
# ---------------------------------------------------------------------------

def to_chrome_trace(merged: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Perfetto-loadable Chrome-trace JSON: ``span`` records become
    complete ("X") slices on a per-rank process / per-phase thread;
    everything else becomes an instant ("i") with the event fields in
    ``args``."""
    if merged:
        t0 = min(r["_t"] for r in merged)
    else:
        t0 = 0.0
    events: List[Dict[str, Any]] = []
    seen_pids = set()
    for rec in merged:
        rank = rec.get("rank", -1)
        pid = int(rank) if isinstance(rank, int) else -1
        ts_us = (rec["_t"] - t0) * 1e6
        if rec.get("kind") == "span":
            name = str(rec.get("name", "span"))
            dur_us = max(float(rec.get("dur", 0.0)) * 1e6, 1.0)
            events.append({
                "name": name,
                "cat": "step",
                "ph": "X",
                # slices end at the emission time (spans are recorded as
                # they close), so they START dur earlier
                "ts": round(max(ts_us - dur_us, 0.0), 3),
                "dur": round(dur_us, 3),
                "pid": pid,
                "tid": name,
                "args": {"update": rec.get("update")},
            })
        else:
            events.append({
                "name": str(rec.get("kind")),
                "cat": "event",
                "ph": "i",
                "s": "p",
                "ts": round(ts_us, 3),
                "pid": pid,
                "tid": "events",
                "args": {
                    k: v for k, v in rec.items()
                    if k not in ("_t", "_file") and not k.startswith("_")
                },
            })
        if pid not in seen_pids:
            seen_pids.add(pid)
            events.append({
                "name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": f"rank {pid}"},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# post-mortem summary
# ---------------------------------------------------------------------------

#: verdict-class kinds, in the order an operator triages them
_SUMMARY_KINDS = (
    "elastic-verdict",
    "guard-diagnosis",
    "sentinel-abort",
    "sentinel-rewind",
    "agreed-stop",
    "checkpoint-fallback",
    "elastic-restart",
)


def _fmt_update(rec) -> str:
    upd = rec.get("update")
    return f"update {upd}" if isinstance(upd, int) and upd >= 0 else "update ?"


def summarize(merged: List[Dict[str, Any]]) -> List[str]:
    """Human-readable post-mortem lines from a merged timeline."""
    lines: List[str] = []
    by_kind: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for rec in merged:
        by_kind[rec.get("kind")].append(rec)

    if merged:
        run_ids = sorted({r.get("run_id") for r in merged if r.get("run_id")})
        attempts = sorted({r.get("attempt", 0) for r in merged})
        ranks = sorted(
            {r.get("rank") for r in merged if isinstance(r.get("rank"), int)}
        )
        lines.append(
            f"run {', '.join(map(str, run_ids)) or '?'}: "
            f"{len(merged)} events from rank(s) "
            f"{', '.join(map(str, ranks))}, attempt(s) "
            f"{', '.join(map(str, attempts))}"
        )

    for rec in by_kind.get("elastic-verdict", ()):
        ranks = rec.get("ranks") or []
        who = (
            "rank " + ",".join(str(r) for r in ranks)
            if ranks
            else "control plane"
        )
        lines.append(
            f"{who} {str(rec.get('verdict', 'verdict')).upper()} observed "
            f"by rank {rec.get('rank')} at {_fmt_update(rec)}: "
            f"{rec.get('message', '')}"
        )
    for rec in by_kind.get("guard-diagnosis", ()):
        lines.append(
            f"rank {rec.get('rank')} consistency DIAGNOSIS at "
            f"{_fmt_update(rec)}: {rec.get('message', '')}"
        )
    for rec in by_kind.get("sentinel-rewind", ()):
        lines.append(
            f"rank {rec.get('rank')} SENTINEL {str(rec.get('action', 'rewind')).upper()} "
            f"at {_fmt_update(rec)} -> snapshot @update "
            f"{rec.get('target_step')}"
        )
    for rec in by_kind.get("sentinel-abort", ()):
        lines.append(
            f"rank {rec.get('rank')} SENTINEL ABORT at {_fmt_update(rec)}: "
            f"{rec.get('message', '')}"
        )
    for rec in by_kind.get("agreed-stop", ()):
        lines.append(
            f"rank {rec.get('rank')} agreed stop at {_fmt_update(rec)}: "
            f"{rec.get('reason', '')}"
        )
    saves = [
        r for r in by_kind.get("checkpoint-save", ())
        if isinstance(r.get("update"), int)
    ]
    if saves:
        last = max(saves, key=lambda r: r["update"])
        lines.append(
            f"last checkpoint save at update {last['update']} "
            f"({last.get('path', '?')})"
        )
    for rec in by_kind.get("checkpoint-fallback", ()):
        lines.append(
            f"rank {rec.get('rank')} CHECKPOINT FALLBACK: "
            f"{rec.get('corrupt', '?')} -> {rec.get('fallback', '?')}"
        )
    loads = by_kind.get("checkpoint-load", ())
    for rec in loads:
        lines.append(
            f"rank {rec.get('rank')} attempt {rec.get('attempt', 0)} "
            f"resumed from {rec.get('path', '?')} @ "
            f"update {rec.get('loaded_updates', '?')}"
        )
    for rec in by_kind.get("elastic-restart", ()):
        lines.append(
            f"rank {rec.get('rank')} RESTART {rec.get('restarts', '?')}: "
            f"membership epoch {rec.get('from_epoch', '?')} -> "
            f"{rec.get('to_epoch', '?')} as rank {rec.get('new_rank', '?')}/"
            f"{rec.get('new_world', '?')} (child exit "
            f"{rec.get('child_exit', '?')})"
        )
    epochs = sorted(
        {
            r.get("membership_epoch")
            for r in merged
            if isinstance(r.get("membership_epoch"), int)
        }
    )
    if len(epochs) > 1:
        lines.append(
            "membership epochs seen: "
            + " -> ".join(str(e) for e in epochs)
        )
    # fleet post-mortem: which replica died, when the router noticed,
    # what got shed in the gap, how far a rolling reload got.  Router
    # journals are anchorless (no trainer updates), so times are the
    # raw-wall offsets from the merged timeline's start.
    t0 = merged[0]["_t"] if merged else 0.0
    for rec in by_kind.get("fleet-verdict", ()):
        verdict = str(rec.get("verdict", "?"))
        if verdict == "control-plane-freeze":
            lines.append(
                f"fleet membership FROZEN at +{rec['_t'] - t0:.3f}s "
                "(KV outage: verdicts freeze, they are never minted "
                "from service silence)"
            )
            continue
        who = rec.get("replica", "?")
        detail = rec.get("message") or rec.get("reason", "")
        lines.append(
            f"replica {who} {verdict.upper()} noticed by the router at "
            f"+{rec['_t'] - t0:.3f}s: {detail}"
        )
    retries = by_kind.get("router-retry", ())
    if retries:
        per: Dict[str, int] = defaultdict(int)
        for rec in retries:
            per[str(rec.get("reason", "?"))] += 1
        lines.append(
            "router retries: "
            + ", ".join(f"{r} x{per[r]}" for r in sorted(per))
        )
    rsheds = by_kind.get("router-shed", ())
    if rsheds:
        rmax: Dict[str, int] = defaultdict(int)
        rseen: Dict[str, int] = defaultdict(int)
        for rec in rsheds:
            reason = str(rec.get("reason", "?"))
            rseen[reason] += 1
            try:
                rmax[reason] = max(rmax[reason], int(rec.get("count", 0)))
            except (TypeError, ValueError):
                pass
        lines.append(
            "router sheds: "
            + ", ".join(
                f"{r} x{max(rmax[r], rseen[r])}" for r in sorted(rmax | rseen)
            )
        )
    for rec in by_kind.get("fleet-reload", ()):
        event = rec.get("event")
        if event == "halt":
            lines.append(
                f"ROLLING RELOAD HALTED at +{rec['_t'] - t0:.3f}s: replica "
                f"{rec.get('replica', '?')} answered "
                f"'{rec.get('outcome', '?')}' — "
                f"{rec.get('never_asked', '?')} replica(s) never asked, "
                "fleet kept the old snapshot"
            )
        elif event == "complete":
            lines.append(
                f"rolling reload complete at +{rec['_t'] - t0:.3f}s: "
                f"{rec.get('swapped', '?')} replica(s) swapped to "
                f"{rec.get('path', '?')}"
            )
    sheds = by_kind.get("serve-shed", ())
    if sheds:
        # shed journaling is SAMPLED past 5/reason (a flood must not make
        # telemetry the bottleneck), but each record carries the exact
        # cumulative count — take the max per reason, falling back to
        # occurrence counting for count-less records (slow-client)
        seen: Dict[str, int] = defaultdict(int)
        max_count: Dict[str, int] = defaultdict(int)
        for rec in sheds:
            reason = str(rec.get("reason", "?"))
            seen[reason] += 1
            try:
                max_count[reason] = max(
                    max_count[reason], int(rec.get("count", 0))
                )
            except (TypeError, ValueError):
                pass
        lines.append(
            "serve sheds: "
            + ", ".join(
                f"{r} x{max(max_count[r], seen[r])}"
                for r in sorted(seen)
            )
        )
    spans = [r for r in merged if r.get("kind") == "span"]
    if spans:
        totals: Dict[str, float] = defaultdict(float)
        for rec in spans:
            totals[str(rec.get("name"))] += float(rec.get("dur", 0.0))
        lines.append(
            "sampled span seconds: "
            + ", ".join(
                f"{name}={totals[name]:.3f}" for name in sorted(totals)
            )
        )
    if not lines:
        lines.append("no events found")
    return lines


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _fmt_line(rec: Dict[str, Any], t0: float) -> str:
    extras = {
        k: v
        for k, v in rec.items()
        if k not in ENVELOPE_KEYS and not k.startswith("_")
    }
    upd = rec.get("update")
    upd_s = f"u{upd:>6}" if isinstance(upd, int) and upd >= 0 else "u     ?"
    detail = " ".join(f"{k}={v}" for k, v in sorted(extras.items()))
    return (
        f"+{rec['_t'] - t0:10.3f}s r{rec.get('rank', '?')}"
        f"a{rec.get('attempt', 0)} {upd_s} {rec.get('kind')}"
        + (f" {detail}" if detail else "")
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="unicore-tpu-torch-trace",
        description="Merge per-host telemetry journals into one causally "
        "ordered run timeline, emit Perfetto JSON, and print a "
        "post-mortem summary.",
    )
    parser.add_argument(
        "path",
        help="telemetry directory (or a run's save dir, or one "
        "events_rank*.jsonl file)",
    )
    parser.add_argument(
        "--out", metavar="FILE", default=None,
        help="write Chrome-trace (Perfetto) JSON of the merged timeline "
        "here (open in ui.perfetto.dev or chrome://tracing)",
    )
    parser.add_argument(
        "--summary-only", action="store_true",
        help="print only the post-mortem summary, not the full timeline",
    )
    parser.add_argument(
        "--kind", action="append", default=None, metavar="KIND",
        help="restrict the printed timeline to these event kinds "
        "(repeatable; the summary always sees everything)",
    )
    args = parser.parse_args(argv)

    files = find_journals(args.path)
    if not files:
        print(
            f"unicore-tpu-torch-trace: no events_rank*.jsonl under {args.path}",
            file=sys.stderr,
        )
        return 2
    records: List[Dict[str, Any]] = []
    for path in files:
        records.extend(load_journal(path))
    merged = merge(records)

    if args.out:
        trace = to_chrome_trace(merged)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        print(
            f"wrote {len(trace['traceEvents'])} trace events to {args.out}"
        )

    if not args.summary_only and merged:
        t0 = merged[0]["_t"]
        wanted = set(args.kind) if args.kind else None
        print(f"== merged timeline ({len(files)} journal(s)) ==")
        for rec in merged:
            if wanted is not None and rec.get("kind") not in wanted:
                continue
            print(_fmt_line(rec, t0))

    print("== post-mortem summary ==")
    for line in summarize(merged):
        print(f"  {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
