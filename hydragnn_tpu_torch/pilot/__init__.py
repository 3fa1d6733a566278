"""The continual-learning retrain pilot (the port's counterpart of
``hydragnn_tpu/pilot/``): a drift incident (``obs/triggers.py``) becomes a
supervised fine-tune over the pinned request-spool window
(``obs/spool.py``), a canary-gated candidate, and a hot reload with no
capture, or a clean rejection that leaves the old weights serving. Every
transition is journaled to disk, so a crashed pilot recovers instead of
flapping, and recorded as a ``pilot`` flight event."""

from hydragnn_tpu_torch.pilot.journal import PilotJournal
from hydragnn_tpu_torch.pilot.pilot import PILOT_STATES, PilotConfig, RetrainPilot

__all__ = ["PilotConfig", "PilotJournal", "RetrainPilot", "PILOT_STATES"]
