"""Crash-safe journal of the retrain pilot's state machine (the port's
counterpart of ``hydragnn_tpu/pilot/journal.py``, with its file format:
a journal either package writes, the other reads).

One append-only JSONL file (``pilot_journal.jsonl``) records every state
transition with the cycle number and the consecutive-failure counter:

  - every ``append`` is one line, flushed and fsynced before the
    in-memory transition counts as committed: a SIGKILL between
    transitions loses nothing, a SIGKILL mid-write leaves one torn tail
    line that :meth:`PilotJournal.entries` skips, and the next append
    starts on a fresh line;
  - :meth:`PilotJournal.recover` classifies the tail on restart: a
    RESTING state (``idle``, ``cooldown``, ``stuck``) means the previous
    pilot exited at rest and its counters carry over; a MID-CYCLE state
    (``drift_confirmed``, ``fine_tuning``, ``canary``, ``reloading``)
    means it died inside a retrain, and the new pilot counts that cycle
    as failed instead of resuming it against a spool that has moved on.

The journal decides no policy: the pilot (``pilot/pilot.py``) applies the
recovery rules.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

RESTING_STATES = ("idle", "cooldown", "stuck")
MID_CYCLE_STATES = ("drift_confirmed", "fine_tuning", "canary", "reloading")
JOURNAL_NAME = "pilot_journal.jsonl"


class PilotJournal:
    """Append-only transition log; one writer (the pilot serialises its
    transitions under its own lock), any number of readers."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    def append(self, state: str, cycle: int, failed_cycles: int, **detail: Any) -> Dict[str, Any]:
        """Durably commit one transition; returns the record written."""
        record: Dict[str, Any] = {"t": time.time(), "state": str(state), "cycle": int(cycle),
                                  "failed_cycles": int(failed_cycles)}
        if detail:
            record["detail"] = detail
        line = json.dumps(record)
        # a kill mid-write leaves a torn tail with no newline: glued to it,
        # the next record would be torn too
        with open(self.path, "ab") as f:
            if f.tell() > 0:
                with open(self.path, "rb") as r:
                    r.seek(-1, os.SEEK_END)
                    torn = r.read(1) != b"\n"
                if torn:
                    f.write(b"\n")
            f.write(line.encode("utf-8") + b"\n")
            f.flush()
            os.fsync(f.fileno())
        return record

    def entries(self) -> List[Dict[str, Any]]:
        """Every committed record, oldest first; a torn line is skipped."""
        if not os.path.exists(self.path):
            return []
        out: List[Dict[str, Any]] = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and "state" in rec:
                    out.append(rec)
        return out

    def last(self) -> Optional[Dict[str, Any]]:
        entries = self.entries()
        return entries[-1] if entries else None

    def recover(self) -> Dict[str, Any]:
        """The tail's class for a restarting pilot: ``{"status":
        "fresh"}`` (no journal), ``"clean"`` (exited at rest; the tail's
        ``state``, ``cycle`` and ``failed_cycles`` carry over) or
        ``"crashed_mid_cycle"``."""
        last = self.last()
        if last is None:
            return {"status": "fresh"}
        base = {"state": last["state"], "cycle": int(last.get("cycle", 0)),
                "failed_cycles": int(last.get("failed_cycles", 0))}
        if last["state"] in RESTING_STATES:
            return {"status": "clean", **base}
        return {"status": "crashed_mid_cycle", **base}
