"""The pod-visibility plane (the port's counterpart of
``hydragnn_tpu/obs/podview.py``): per-host flight shards, their merge
into one timeline, and straggler and skew detection for runs of several
hosts.

  - **Per-host flight shards.** Host 0 keeps the canonical
    ``flight.jsonl``; host k writes its own ``flight.host<k>.jsonl`` in
    the same run directory (:func:`host_flight_path`), and a fixed-name
    artifact such as ``train.prom`` becomes ``train.host<k>.prom``
    (:func:`host_artifact_path`). :func:`merge_host_flights` joins the
    shards on ``(run_id, epoch)``, tolerates torn tails and missing hosts,
    and feeds the Chrome export (``obs/trace.py``, one track a host) and
    the JAX package's ``tools/obs_report.py --hosts``, which reads a port
    run directory unchanged.
  - **Skew detection.** Each host appends a ``host_epoch`` summary
    (epoch wall, data wait, steps, MFU) to its shard; host 0's
    :class:`SkewMonitor` reads the peers' shards at each epoch boundary,
    computes the epoch's duration skew and the slowest host, and sets the
    ``podview.skew_frac``, ``podview.slowest_host`` and
    ``podview.stall_age_s`` gauges (and ``podview.host<k>.mfu``) that the
    ``step_skew`` and ``host_stall`` trigger rules read.
  - **Collective attribution.** :func:`collective_attribution` splits a
    modelled step into compute and wire time from a ``scaling`` dict the
    caller passes. The port reads no scaling estimate of its own: the
    JAX package's ``SCALING_est_*.json`` model a TPU, so without a dict
    the attribution says ``modeled: False``.

Host identity: ``HGTORCH_PODVIEW_HOST`` and ``HGTORCH_PODVIEW_HOSTS``
first (simulated hosts on one machine, which join on a shared
``HGTORCH_PODVIEW_RUN_ID``), else the rank and world size of an
initialised ``torch.distributed`` group, else ``(0, 1)``. Every function
here degrades to "no podview data" rather than take a run down. A pod without a shared filesystem exchanges samples through
``data/diststore.py``.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

from hydragnn_tpu_torch.obs.flight import read_flight_record
from hydragnn_tpu_torch.obs.registry import env_number

#: the canonical (host 0) shard's file name
CANONICAL_SHARD = "flight.jsonl"
_SHARD_RE = re.compile(r"^flight\.host([0-9]+)\.jsonl$")

PODVIEW_REPORT = "podview_report.json"
PODVIEW_REPORT_SCHEMA = 1

#: the ``step_skew`` threshold when neither ``HGTORCH_PODVIEW_SKEW`` nor
#: the caller gives one
DEFAULT_SKEW_THRESHOLD = 0.25

#: the skew verdicts a monitor keeps (its memory and the report's size)
_HISTORY_MAX = 64


# -- host identity ----------------------------------------------------------


def host_identity() -> Tuple[int, int]:
    """``(host_index, host_count)`` of this process (module docstring)."""
    host = int(env_number("HGTORCH_PODVIEW_HOST", -1))
    hosts = int(env_number("HGTORCH_PODVIEW_HOSTS", 0))
    if host < 0 or hosts <= 0:
        try:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                if host < 0:
                    host = int(dist.get_rank())
                if hosts <= 0:
                    hosts = int(dist.get_world_size())
        except (ImportError, RuntimeError):
            pass
    host = max(host, 0)
    return host, max(hosts, host + 1, 1)


def podview_enabled() -> bool:
    """On when forced (``HGTORCH_PODVIEW=1``) or when the run spans more
    than one host, real or simulated."""
    if os.environ.get("HGTORCH_PODVIEW", "").strip().lower() in ("1", "true", "yes", "on"):
        return True
    return host_identity()[1] > 1


def resolve_run_id(default: Optional[str] = None) -> Optional[str]:
    """The key a run's host shards join on: ``HGTORCH_PODVIEW_RUN_ID``
    when set (how simulated hosts agree), else ``default`` (the run's log
    name)."""
    return os.environ.get("HGTORCH_PODVIEW_RUN_ID") or default


# -- shard naming -----------------------------------------------------------


def host_flight_path(base_dir: str, host: Optional[int] = None) -> str:
    """Host ``host``'s flight shard under ``base_dir``: ``flight.jsonl``
    for host 0, ``flight.host<k>.jsonl`` for host k."""
    if host is None:
        host = host_identity()[0]
    name = CANONICAL_SHARD if host == 0 else f"flight.host{host}.jsonl"
    return os.path.join(base_dir, name)


def host_artifact_path(path: str, host: Optional[int] = None) -> str:
    """``path`` with this host's index before its extension on hosts
    other than 0 (``x/train.prom`` -> ``x/train.host2.prom``), so a
    second host never overwrites the first's file."""
    if host is None:
        host = host_identity()[0]
    if host <= 0:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.host{host}{ext}"


def list_host_shards(base_dir: str) -> Dict[int, str]:
    """``{host_index: shard_path}`` of every flight shard in ``base_dir``."""
    shards: Dict[int, str] = {}
    try:
        names = os.listdir(base_dir)
    except OSError:
        return shards
    for name in names:
        if name == CANONICAL_SHARD:
            shards[0] = os.path.join(base_dir, name)
            continue
        m = _SHARD_RE.match(name)
        if m:
            shards[int(m.group(1))] = os.path.join(base_dir, name)
    return shards


# -- merge reader -----------------------------------------------------------


class MergedFlights(NamedTuple):
    """:func:`merge_host_flights`'s result: the stitched events (each
    stamped with its ``host``), the hosts present, and the problems
    found (torn tails, missing hosts, duplicates), which never fail the
    merge."""

    events: List[dict]
    hosts: List[int]
    problems: List[str]


def _torn_tail(path: str) -> bool:
    """True when the shard's last non-empty line is not JSON: a writer
    that died mid-append (``read_flight_record`` skips the line)."""
    try:
        with open(path) as f:
            lines = [ln for ln in f.read().split("\n") if ln.strip()]
    except OSError:
        return False
    if not lines:
        return False
    try:
        json.loads(lines[-1])
        return False
    except json.JSONDecodeError:
        return True


def merge_host_flights(source: Union[str, List[str]], expected_hosts: Optional[int] = None) -> MergedFlights:
    """Stitch per-host flight shards into one timeline.

    ``source`` is a run directory (every shard in it), one shard's path,
    or a list of shard paths. Each event is stamped with ``host`` (from
    the shard's file name, else the event's ``rank``); the events are
    sorted by time. A torn tail, a missing host (fewer shards than the
    manifests, the ``host_epoch`` events or ``HGTORCH_PODVIEW_HOSTS``
    promise), an unparseable line inside a shard and a duplicate
    ``(run_id, host, epoch)`` summary are each reported in ``problems``;
    everything readable is merged."""
    if isinstance(source, str) and os.path.isdir(source):
        shards = list_host_shards(source)
        paths = [shards[h] for h in sorted(shards)]
    elif isinstance(source, str):
        paths = [source]
    else:
        paths = list(source)

    problems: List[str] = []
    events: List[dict] = []
    hosts_seen: List[int] = []
    promised = 0
    seen_summaries: Dict[Tuple[Any, int, int], int] = {}

    for path in paths:
        name = os.path.basename(path)
        m = _SHARD_RE.match(name)
        file_host = int(m.group(1)) if m else (0 if name == CANONICAL_SHARD else None)
        try:
            shard_events = read_flight_record(path)
        except OSError:
            problems.append(f"{name}: unreadable shard")
            continue
        if _torn_tail(path):
            problems.append(f"{name}: torn tail (final line truncated, skipped)")
        shard_hosts = set()
        for ev in shard_events:
            if ev.get("kind") == "_unparseable":
                problems.append(f"{name}: unparseable interior line")
                continue
            host = file_host if file_host is not None else int(ev.get("rank", 0) or 0)
            ev = dict(ev, host=host)
            shard_hosts.add(host)
            if ev.get("kind") == "host_epoch":
                promised = max(promised, int(ev.get("hosts", 0) or 0))
                key = (ev.get("run_id"), host, int(ev.get("epoch", -1)))
                seen_summaries[key] = seen_summaries.get(key, 0) + 1
            elif ev.get("kind") == "run_start":
                man = ev.get("manifest")
                if isinstance(man, dict):
                    try:
                        promised = max(promised, int(man.get("num_processes", 0) or 0))
                    except (TypeError, ValueError):
                        pass
            events.append(ev)
        for h in sorted(shard_hosts):
            if h not in hosts_seen:
                hosts_seen.append(h)

    for key, count in sorted(seen_summaries.items(), key=lambda kv: str(kv[0])):
        if count > 1:
            run_id, host, epoch = key
            problems.append(
                f"duplicate host_epoch for run_id={run_id!r} host={host} epoch={epoch} ({count} copies)"
            )

    if expected_hosts is None:
        expected_hosts = max(int(env_number("HGTORCH_PODVIEW_HOSTS", 0)), promised)
    if expected_hosts:
        missing = sorted(set(range(expected_hosts)) - set(hosts_seen))
        if missing:
            problems.append(
                f"missing host shard(s): {missing} (expected {expected_hosts} hosts, saw {sorted(hosts_seen)})"
            )

    events.sort(key=lambda ev: (ev.get("t") or 0.0))
    return MergedFlights(events=events, hosts=sorted(hosts_seen), problems=problems)


def host_epoch_table(events: List[dict], run_id: Optional[str] = None) -> Dict[int, Dict[int, dict]]:
    """The merge's join: ``{epoch: {host: host_epoch event}}``, of one
    ``run_id`` when given."""
    table: Dict[int, Dict[int, dict]] = {}
    for ev in events:
        if ev.get("kind") != "host_epoch":
            continue
        if run_id is not None and ev.get("run_id") not in (None, run_id):
            continue
        epoch = int(ev.get("epoch", -1))
        host = int(ev.get("host", ev.get("rank", 0)) or 0)
        table.setdefault(epoch, {})[host] = ev
    return table


# -- straggler injection ----------------------------------------------------


def straggler_spec() -> Optional[Tuple[int, float]]:
    """``HGTORCH_INJECT_STRAGGLER="HOST:MS"`` as ``(host_index,
    sleep_seconds)``; None when unset or malformed (a bad spec means no
    injection, not a crash)."""
    v = os.environ.get("HGTORCH_INJECT_STRAGGLER")
    if not v:
        return None
    try:
        host, ms = v.split(":", 1)
        return int(host), float(ms) / 1e3
    except (ValueError, TypeError):
        return None


# -- scaling-model coupling -------------------------------------------------


def load_skew_tolerance(path: Optional[str] = None) -> float:
    """The ``step_skew`` threshold of a scaling estimate at ``path``
    (its ``skew_tolerance.default_step_skew_threshold``), or
    :data:`DEFAULT_SKEW_THRESHOLD`. With no path, the default: the port
    looks for no estimate of its own (module docstring)."""
    if not path or not os.path.exists(path):
        return DEFAULT_SKEW_THRESHOLD
    try:
        with open(path) as f:
            rec = json.load(f)
        thr = rec.get("skew_tolerance", {}).get("default_step_skew_threshold")
        if thr is not None:
            return float(thr)
    except (OSError, ValueError, AttributeError, TypeError):
        pass
    return DEFAULT_SKEW_THRESHOLD


def default_skew_threshold() -> float:
    """``HGTORCH_PODVIEW_SKEW`` when positive, else
    :data:`DEFAULT_SKEW_THRESHOLD`."""
    knob = env_number("HGTORCH_PODVIEW_SKEW", 0.0)
    return knob if knob > 0 else load_skew_tolerance()


def collective_attribution(parallel: Optional[dict], scaling: Optional[dict] = None) -> dict:
    """Split a modelled step into compute and collective wire time for
    the run's layout, with the ring all-reduce and FSDP traffic formulas
    of the JAX package's ``tools/scaling_estimate.py``: a data-parallel
    gradient all-reduce moves ``2(n-1)/n`` of the gradient bytes, FSDP
    adds an all-gather and a reduce-scatter of ``(f-1)/f`` each.
    ``scaling`` gives ``step_ms_device_single_chip``, the wire rate
    ``ici_gbps_assumed`` (GB/s, 45 when absent) and optionally
    ``param_bytes_f32``. Without it the result is ``modeled: False`` with
    a note."""
    out: Dict[str, Any] = {"modeled": False, "compute_ms": None, "wire_ms": None, "wire_frac": None, "note": ""}
    if not isinstance(parallel, dict) or not parallel.get("available", False):
        out["note"] = "no parallel layout committed (single-device run)"
        return out
    if not scaling:
        out["note"] = "no scaling estimate given (the port reads none of its own)"
        return out
    try:
        step_ms = float(scaling["step_ms_device_single_chip"])
        ici_bps = float(scaling.get("ici_gbps_assumed", 45.0)) * 1e9
        params = parallel.get("params") or {}
        grad_bytes = float(params.get("bytes_global") or scaling.get("param_bytes_f32") or 0.0)
        n_data = int(parallel.get("data") or 1)
        n_fsdp = int(parallel.get("fsdp") or 1)
        wire_bytes = 0.0
        if n_data > 1:
            wire_bytes += 2.0 * (n_data - 1) / n_data * grad_bytes
        if n_fsdp > 1:
            wire_bytes += (n_fsdp - 1) / n_fsdp * 2.0 * grad_bytes
        wire_ms = wire_bytes / ici_bps * 1e3
        total = step_ms + wire_ms
        out.update(
            modeled=True,
            compute_ms=round(step_ms, 4),
            wire_ms=round(wire_ms, 4),
            wire_frac=round(wire_ms / total, 6) if total > 0 else 0.0,
            data=n_data,
            fsdp=n_fsdp,
            note="ring all-reduce + FSDP ag/rs traffic model vs the committed layout (tools/scaling_estimate.py)",
        )
    except (KeyError, TypeError, ValueError, ZeroDivisionError) as e:
        out["note"] = f"attribution unavailable: {e}"
    return out


# -- skew monitor -----------------------------------------------------------


class SkewMonitor:
    """Host 0's cross-host skew detector, fed by the shards on the shared
    filesystem.

    The train loop calls :meth:`observe_epoch` once an epoch boundary,
    from its own thread, so there is no lock. A failure in it means "no
    skew data this epoch", never a failed run. The monitor times its own
    reads: :attr:`overhead_s`, from which ``run_end``'s
    ``podview.overhead_frac`` is computed."""

    def __init__(self, base_dir: str, host: int = 0, hosts: int = 1, run_id: Optional[str] = None,
                 registry=None, parallel: Optional[dict] = None, threshold: Optional[float] = None,
                 scaling: Optional[dict] = None):
        self.base_dir = base_dir
        self.host = host
        self.hosts = hosts
        self.run_id = run_id
        self.registry = registry
        self.parallel = parallel
        self.threshold = threshold if threshold and threshold > 0 else default_skew_threshold()
        self.history: List[dict] = []
        self.overhead_s = 0.0
        self._scaling = scaling
        # a host that never writes a shard counts as stalled from the
        # monitor's start, not from the unix epoch
        self._t0 = time.time()
        # per shard: its open file, its newest event time, its host_epoch
        # events of this run by epoch (in file order), and a line still
        # being written when last read
        self._shards: Dict[str, list] = {}

    def set_parallel(self, parallel: Optional[dict]) -> None:
        """The Partitioner's manifest, once the run has one."""
        self.parallel = parallel

    def observe_epoch(self, epoch: int, summary: Optional[dict] = None):
        """Read every host's ``host_epoch`` summary of ``epoch`` from the
        shards, compute the skew, set the gauges. ``summary`` is this
        host's own record. Returns the skew dict (the ``podview`` flight
        event's fields), or None when fewer than two hosts reported."""
        t0 = time.perf_counter()
        try:
            return self._observe(int(epoch), summary)
        except Exception:
            return None  # no skew data this epoch
        finally:
            self.overhead_s += time.perf_counter() - t0

    def _scan(self, path: str) -> Optional[Tuple[float, Dict[int, List[dict]]]]:
        """The shard's newest event time and its host_epoch events by
        epoch. The shard stays open and only what it gained since the last
        scan is read (the JAX monitor opens and re-reads every shard whole
        each epoch, which on a slow filesystem costs a short run more than
        1% of its wall; the verdicts are the same). Shards are only ever
        appended to. A line still being written waits for the next scan."""
        st = self._shards.get(path)
        try:
            if st is None:
                st = self._shards[path] = [open(path, "rb"), 0.0, {}, b""]
            data = st[3] + st[0].read()
        except OSError:
            return None
        end = data.rfind(b"\n") + 1
        st[3] = data[end:]
        latest, by_epoch = st[1], st[2]
        for raw in data[:end].splitlines():
            try:
                ev = json.loads(raw)
            except ValueError:
                continue  # blank or unparseable: no event
            t = ev.get("t")
            if isinstance(t, (int, float)):
                latest = max(latest, float(t))
            if ev.get("kind") != "host_epoch":
                continue
            if self.run_id is not None and ev.get("run_id") not in (None, self.run_id):
                continue
            by_epoch.setdefault(int(ev.get("epoch", -1)), []).append(ev)
        st[1] = latest
        return latest, by_epoch

    def close(self) -> None:
        """Close the shards the monitor holds open."""
        for st in self._shards.values():
            st[0].close()
        self._shards.clear()

    def _observe(self, epoch: int, summary: Optional[dict]):
        per_host: Dict[int, dict] = {}
        latest_t: Dict[int, float] = {}
        for h, path in list_host_shards(self.base_dir).items():
            scanned = self._scan(path)
            if scanned is None:
                continue
            if scanned[0] > 0:
                latest_t[h] = scanned[0]
            for ev in scanned[1].get(epoch, []):
                per_host[int(ev.get("host", h) or h)] = ev
        if summary is not None:
            per_host.setdefault(self.host, dict(summary, host=self.host))

        now = time.time()
        stall_age = 0.0
        for h in range(self.hosts):
            if h != self.host:
                stall_age = max(stall_age, now - latest_t.get(h, self._t0))

        skew = None
        if len(per_host) >= 2:
            durs = {h: float(ev.get("epoch_s") or 0.0) for h, ev in per_host.items()}
            t_max = max(durs.values())
            slowest = max(sorted(durs), key=lambda h: durs[h])
            skew_frac = (t_max - min(durs.values())) / t_max if t_max > 0 else 0.0
            waits = {h: float(ev.get("data_wait_s") or 0.0) for h, ev in per_host.items()}
            attribution = collective_attribution(self.parallel, self._scaling)
            # the cause: the slowest host starved of data first; skew inside
            # the modelled wire share is the interconnect; else the host
            slow_excess = t_max - min(durs.values())
            if waits.get(slowest, 0.0) >= 0.5 * slow_excess > 0:
                cause = "data_wait"
            elif attribution.get("modeled") and skew_frac <= (attribution.get("wire_frac") or 0.0):
                cause = "interconnect"
            else:
                cause = "host_slow"
            skew = {
                "epoch": epoch,
                "skew_frac": round(skew_frac, 6),
                "slowest_host": slowest,
                "cause": cause,
                "threshold": self.threshold,
                "hosts_reporting": sorted(per_host),
                "epoch_s": {str(h): round(durs[h], 4) for h in sorted(durs)},
                "data_wait_s": {str(h): round(waits[h], 4) for h in sorted(waits)},
            }
            self.history.append(skew)
            del self.history[:-_HISTORY_MAX]

        if self.registry is not None:
            self.registry.gauge("podview.skew_frac").set(skew["skew_frac"] if skew else 0.0)
            self.registry.gauge("podview.slowest_host").set(float(skew["slowest_host"]) if skew else -1.0)
            self.registry.gauge("podview.stall_age_s").set(round(stall_age, 3))
            for h, ev in per_host.items():
                mfu = ev.get("mfu")
                if isinstance(mfu, (int, float)):
                    self.registry.gauge(f"podview.host{h}.mfu").set(float(mfu))
        return skew

    def report(self) -> dict:
        """The ``podview_report.json`` body: the last verdict, the skew
        history, the attribution and the monitor's own overhead."""
        last = self.history[-1] if self.history else None
        return {
            "schema": PODVIEW_REPORT_SCHEMA,
            "host": self.host,
            "hosts": self.hosts,
            "run_id": self.run_id,
            "threshold": self.threshold,
            "skew_frac": last["skew_frac"] if last else None,
            "slowest_host": last["slowest_host"] if last else None,
            "cause": last["cause"] if last else None,
            "history": self.history[-32:],
            "attribution": collective_attribution(self.parallel, self._scaling),
            "overhead_s": round(self.overhead_s, 6),
        }

    def shard_tails(self, tail_lines: int = 50) -> Dict[int, List[str]]:
        """The last ``tail_lines`` lines of every host's shard: the
        per-host evidence of an incident bundle."""
        tails: Dict[int, List[str]] = {}
        for h, path in list_host_shards(self.base_dir).items():
            try:
                with open(path) as f:
                    tails[h] = f.read().splitlines()[-tail_lines:]
            except OSError:
                continue
        return tails


def validate_podview_report(data) -> List[str]:
    """The problems of a ``podview_report.json`` body (empty: valid)."""
    problems: List[str] = []
    if not isinstance(data, dict):
        return ["podview report is not a dict"]
    if not isinstance(data.get("schema"), int):
        problems.append("missing/invalid field 'schema' (int)")
    for field in ("host", "hosts"):
        if not isinstance(data.get(field), int):
            problems.append(f"missing/invalid field {field!r} (int)")
    if not isinstance(data.get("threshold"), (int, float)):
        problems.append("missing/invalid field 'threshold' (number)")
    if not isinstance(data.get("history"), list):
        problems.append("missing/invalid field 'history' (list)")
    if not isinstance(data.get("attribution"), dict):
        problems.append("missing/invalid field 'attribution' (dict)")
    sh = data.get("slowest_host")
    if sh is not None and not isinstance(sh, int):
        problems.append("field 'slowest_host' must be an int or null")
    return problems
