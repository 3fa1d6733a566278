"""The port's exit-code contract, preemption handler, restart supervisor
and its CLI against the JAX package's (``hydragnn_tpu/resilience/
{preempt,supervisor}.py``, ``tools/supervise.py``): the same return-code
sequences through both supervisors give equal results, histories,
``restart`` events, backoff sleeps and child environments (the port's
``HGTORCH_`` names read as the JAX package's ``HYDRAGNN_``); the same
exceptions through both ``run_guard``s give equal exit codes; the same
child through both ``wall_clock_runner``s gives the same process calls.
No tolerance: every comparison is exact. The hard-exit timer and the
supervise CLI run in child processes, never in the test worker."""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from hydragnn_tpu.resilience import preempt as jpre
from hydragnn_tpu.resilience import supervisor as jsup
from hydragnn_tpu.utils.checkpoint import CheckpointFormatError as JaxCheckpointFormatError

from hydragnn_tpu_torch.resilience import preempt as tpre
from hydragnn_tpu_torch.resilience import supervisor as tsup
from hydragnn_tpu_torch.resilience.sentry import NonFiniteRollbackExhausted
from hydragnn_tpu_torch.utils.checkpoint import CheckpointFormatError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _as_jax_names(env):
    return {k.replace("HGTORCH_", "HYDRAGNN_", 1): v for k, v in env.items()}


def test_exit_codes_equal_the_jax_package():
    for name in ("EXIT_OK", "EXIT_PREEMPTED", "EXIT_ROLLBACK_EXHAUSTED", "EXIT_CONFIG_ERROR", "EXIT_HUNG"):
        assert getattr(tpre, name) == getattr(jpre, name), name
    assert NonFiniteRollbackExhausted.exit_code == jpre.NonFiniteRollbackExhausted.exit_code == 76
    assert tpre.TrainingPreempted.exit_code == jpre.TrainingPreempted.exit_code == 75
    assert str(tpre.TrainingPreempted(15, 3)) == str(jpre.TrainingPreempted(15, 3))
    assert str(tpre.TrainingPreempted(999, 1)) == str(jpre.TrainingPreempted(999, 1))
    assert tsup.FAIL_FAST_CAUSES == jsup.FAIL_FAST_CAUSES
    assert tsup.PREEMPT_CLASS_CAUSES == jsup.PREEMPT_CLASS_CAUSES


def test_classify_exit_matches_jax():
    for rc in range(-20, 256):
        assert tsup.classify_exit(rc) == jsup.classify_exit(rc), rc


class _Flight:
    def __init__(self):
        self.calls = []

    def record(self, kind, **payload):
        self.calls.append((kind, payload))

    def end_run(self, status, **payload):
        self.calls.append(("run_end", dict(payload, status=status)))


POLICIES = {
    "default": {},
    "two_restarts": dict(max_restarts=2, backoff_base_s=0.5, backoff_factor=3.0, backoff_max_s=4.0),
    "no_restarts": dict(max_restarts=0),
    "one_preemption": dict(max_preemptions=1),
}
SEQUENCES = [
    ("crash_hung_then_ok", [1, 79, 0], "default"),
    ("config_error", [78], "default"),
    ("rollback_exhausted", [76], "default"),
    ("crashes_give_up", [1, 1, 1, 1], "two_restarts"),
    ("backoff_capped", [1, -9, 1, 0], "two_restarts"),
    ("preemptions_not_crashes", [75, 75, 0], "no_restarts"),
    ("preemptions_give_up", [75, 75, 75], "one_preemption"),
    ("signal_deaths", [-9, -15, 75, 0], "default"),
    ("hung_give_up", [79], "no_restarts"),
]


@pytest.mark.parametrize("codes,policy", [(c, p) for _, c, p in SEQUENCES], ids=[n for n, _, _ in SEQUENCES])
def test_supervisor_matches_jax(codes, policy):
    """Both supervisors on one return-code sequence: equal result dicts,
    histories, flight calls (``restart`` fields and ``run_end``), sleeps
    and child environments."""
    runs = []
    for mod, env in ((jsup, {"HYDRAGNN_INJECT_SIGTERM_STEP": "3", "HYDRAGNN_INJECT_NAN_STEP": "1:2", "KEEP": "1"}),
                     (tsup, {"HGTORCH_INJECT_SIGTERM_STEP": "3", "HGTORCH_INJECT_NAN_STEP": "1:2", "KEEP": "1"})):
        it = iter(codes)
        envs, delays, flight = [], [], _Flight()
        sup = mod.Supervisor(["cmd", "arg"], policy=mod.SupervisorPolicy(**POLICIES[policy]), env=env,
                             flight=flight, runner=lambda argv, e: (envs.append(dict(e)), next(it))[1],
                             sleep=delays.append)
        runs.append((sup.run(), flight.calls, delays, envs))
    (jres, jcalls, jdelays, jenvs), (res, calls, delays, envs) = runs
    assert res == jres
    assert calls == jcalls
    assert delays == jdelays
    assert [_as_jax_names(e) for e in envs] == jenvs
    assert "HGTORCH_AUTO_RESUME" not in envs[0] and "HGTORCH_INJECT_SIGTERM_STEP" in envs[0]
    for e in envs[1:]:
        assert e["HGTORCH_AUTO_RESUME"] == "1" and not any(k.startswith("HGTORCH_INJECT_") for k in e)


@pytest.mark.parametrize("auto_resume,strip", [(False, True), (True, False)])
def test_supervisor_policy_switches_match_jax(auto_resume, strip):
    envs = {}
    for mod, env in ((jsup, {"HYDRAGNN_INJECT_SIGTERM_EPOCH": "1"}), (tsup, {"HGTORCH_INJECT_SIGTERM_EPOCH": "1"})):
        it = iter([75, 0])
        seen = []
        mod.Supervisor(["c"], policy=mod.SupervisorPolicy(auto_resume=auto_resume, strip_injection=strip), env=env,
                       runner=lambda a, e: (seen.append(dict(e)), next(it))[1]).run()
        envs[mod] = seen
    assert [_as_jax_names(e) for e in envs[tsup]] == envs[jsup]


class _FakeProc:
    def __init__(self, log, timeouts, rc):
        self.log, self.timeouts, self.rc = log, list(timeouts), rc

    def wait(self, timeout=None):
        self.log.append(("wait", timeout))
        if self.timeouts and self.timeouts.pop(0):
            raise subprocess.TimeoutExpired("child", timeout)
        return self.rc

    def terminate(self):
        self.log.append(("terminate",))

    def kill(self):
        self.log.append(("kill",))


@pytest.mark.parametrize("timeouts,rc", [((False,), 0), ((False,), 75), ((True, False), -15), ((True, True, False), -9)],
                         ids=["ok", "preempted", "terminated", "killed"])
def test_wall_clock_runner_matches_jax(timeouts, rc):
    out = {}
    for mod in (jsup, tsup):
        log = []

        def popen(argv, env=None):
            log.append(("popen", tuple(argv), env["X"]))
            return _FakeProc(log, timeouts, rc)

        got = mod.wall_clock_runner(12.5, grace_s=2.0, popen=popen)(["child", "a"], {"X": "y"})
        out[mod] = (got, log)
    assert out[tsup] == out[jsup]
    assert out[tsup][0] == (79 if timeouts[0] else rc)
    for mod in (jsup, tsup):
        with pytest.raises(ValueError):
            mod.wall_clock_runner(0)


GUARDED = [
    ("preempted", lambda m: m["TrainingPreempted"](15, 3)),
    ("rollback", lambda m: m["NonFiniteRollbackExhausted"]("gave up")),
    ("value", lambda m: ValueError("bad config")),
    ("key", lambda m: KeyError("Architecture")),
    ("type", lambda m: TypeError("bad type")),
    ("missing_file", lambda m: FileNotFoundError("no dataset")),
    ("format", lambda m: m["CheckpointFormatError"]("newer format")),
    ("runtime", lambda m: RuntimeError("boom")),
    ("os", lambda m: OSError("disk")),
]
JAX_SIDE = {"TrainingPreempted": jpre.TrainingPreempted, "NonFiniteRollbackExhausted": jpre.NonFiniteRollbackExhausted,
            "CheckpointFormatError": JaxCheckpointFormatError}
PORT_SIDE = {"TrainingPreempted": tpre.TrainingPreempted, "NonFiniteRollbackExhausted": NonFiniteRollbackExhausted,
             "CheckpointFormatError": CheckpointFormatError}


def _guard_outcome(guard, exc):
    try:
        with guard():
            raise exc
    except SystemExit as e:
        return ("exit", e.code)
    except BaseException as e:  # the crash class propagates untouched
        return ("raised", type(e).__name__, e is exc)


@pytest.mark.parametrize("make", [m for _, m in GUARDED], ids=[n for n, _ in GUARDED])
def test_run_guard_codes_match_jax(make, capsys):
    port = _guard_outcome(tpre.run_guard, make(PORT_SIDE))
    assert port == _guard_outcome(jpre.run_guard, make(JAX_SIDE))
    capsys.readouterr()


@pytest.mark.parametrize("knob,exists", [(None, True), ("1", False), ("1", True), ("0", True)])
def test_auto_resume_config_matches_jax(knob, exists, tmp_path, monkeypatch):
    for name in ("HYDRAGNN_AUTO_RESUME", "HGTORCH_AUTO_RESUME"):
        if knob is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, knob)
    if exists:
        os.makedirs(tmp_path / "run")
        for f in ("run.mp", "run.pt"):  # the JAX package's latest file and the port's
            (tmp_path / "run" / f).write_bytes(b"x")
    out = []
    for mod in (jpre, tpre):
        training = {"num_epoch": 4}
        out.append((mod.auto_resume_config(training, "run", str(tmp_path)), training))
    assert out[0] == out[1]
    assert out[1][0] == (knob == "1" and exists)


def test_handler_sets_the_flag_and_uninstall_cancels_its_timer():
    assert threading.current_thread() is threading.main_thread()
    before = signal.getsignal(signal.SIGUSR2)
    h = tpre.PreemptionHandler(signals=(signal.SIGUSR2,), grace_s=30.0).install()
    try:
        assert h.available and signal.getsignal(signal.SIGUSR2) == h._handle
        assert not h.should_stop()
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 5
        while not h.should_stop() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert h.should_stop() and h.signum == signal.SIGUSR2
        timer = h._timer
        assert timer is not None and timer.is_alive()
    finally:
        h.uninstall()
    assert h._timer is None and not h.available
    timer.join(1.0)
    assert not timer.is_alive()  # cancelled: the process is not hard-exited
    assert signal.getsignal(signal.SIGUSR2) == before


def test_handler_off_the_main_thread_is_inert():
    out = {}

    def worker():
        for mod in (jpre, tpre):
            out[mod] = mod.PreemptionHandler(signals=(signal.SIGUSR2,)).install().available

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert out == {jpre: False, tpre: False}


_TIMER_CHILD = r"""
import os, signal, sys, time
sys.path.insert(0, {repo!r})
from hydragnn_tpu_torch.resilience.preempt import PreemptionHandler
h = PreemptionHandler(grace_s=0.3).install()
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(0.05)
assert h.should_stop() and h.signum == signal.SIGTERM
if sys.argv[1] == "teardown":
    h.uninstall()
time.sleep(3.0)
print("ALIVE", flush=True)
"""


@pytest.mark.parametrize("mode,rc", [("teardown", 0), ("carry_on", 75)])
def test_hard_exit_timer_in_a_child(mode, rc, tmp_path):
    """After SIGTERM the handler's timer exits the process with 75 once
    ``grace_s`` has passed, unless ``uninstall`` cancelled it."""
    script = tmp_path / "child.py"
    script.write_text(_TIMER_CHILD.format(repo=REPO))
    proc = subprocess.run([sys.executable, str(script), mode], capture_output=True, text=True, timeout=120)
    assert proc.returncode == rc, proc.stderr[-2000:]
    assert ("ALIVE" in proc.stdout) == (rc == 0)
    if rc:
        assert "grace window (0.3s) exceeded" in proc.stderr


def _supervise(args, env=None, timeout=120):
    return subprocess.run([sys.executable, "-m", "hydragnn_tpu_torch.tools.supervise", *args], cwd=REPO,
                          env=dict(os.environ, **(env or {})), capture_output=True, text=True, timeout=timeout)


_POD_CHILD = r"""
import glob, os, signal, sys, time
host, hosts = int(os.environ["HGTORCH_PODVIEW_HOST"]), int(os.environ["HGTORCH_PODVIEW_HOSTS"])
assert os.environ["HGTORCH_PODVIEW_RUN_ID"] == "clirun"
open(os.path.join(sys.argv[1], f"launch.{os.getpid()}"), "w").write(f"{host} {hosts}")
if host == 1 and os.environ.get("HGTORCH_INJECT_POD_KILL_HOST"):
    # die once host 0 has started, as a host lost mid-run
    deadline = time.time() + 60
    while time.time() < deadline and not any(open(p).read() == f"0 {hosts}"
                                             for p in glob.glob(os.path.join(sys.argv[1], "launch.*"))):
        time.sleep(0.05)
    os.kill(os.getpid(), signal.SIGKILL)
"""


@pytest.mark.parametrize("flag", [["--pod", "2"], ["--pod", "2", "--pod-elastic"]])
def test_supervise_cli_refuses_pod_mode(flag, tmp_path):
    """The name is the refusal's, kept: ``--pod`` and ``--pod-elastic`` now
    run a pod. Host 1 dies of SIGKILL in the first attempt; the pod
    restarts at once, at 2 hosts or (elastic) 1, and completes."""
    from hydragnn_tpu_torch.obs.flight import read_flight_record

    script = tmp_path / "child.py"
    script.write_text(_POD_CHILD)
    flight = tmp_path / "sup.jsonl"
    proc = _supervise([*flag, "--run-id", "clirun", "--pod-grace", "5", "--flight", str(flight), "--",
                       sys.executable, str(script), str(tmp_path)], env={"HGTORCH_INJECT_POD_KILL_HOST": "1:1"})
    assert proc.returncode == tpre.EXIT_OK, proc.stderr[-2000:]
    width = 1 if "--pod-elastic" in flag else 2
    launches = sorted(open(p).read() for p in tmp_path.glob("launch.*"))
    assert launches == sorted(["0 2", "1 2"] + [f"{h} {width}" for h in range(width)])
    events = read_flight_record(str(flight))
    (lost,) = [e for e in events if e["kind"] == "host_lost"]
    (restart,) = [e for e in events if e["kind"] == "restart"]
    assert lost["host"] == 1 and lost["exit_code"] == -signal.SIGKILL
    assert (restart["cause"], restart["delay_s"], restart["hosts"]) == ("host_lost", 0.0, width)
    assert [e["status"] for e in events if e["kind"] == "run_end"] == ["completed"]


def test_supervise_cli_usage_errors():
    assert _supervise([sys.executable, "-c", "pass"]).returncode == 2
    assert _supervise(["--"]).returncode == 2


_FLAKY_CHILD = r"""
import os, sys
marker = sys.argv[1]
if os.environ.get("HGTORCH_INJECT_SIGTERM_EPOCH"):
    open(marker, "w").write("first")
    sys.exit(75)
assert os.environ.get("HGTORCH_AUTO_RESUME") == "1"
sys.exit(int(os.environ.get("CHILD_RC", "0")))
"""


@pytest.mark.parametrize("final_rc,status", [(0, "completed"), (78, "failed_fast")])
def test_supervise_cli_restarts_after_a_preemption(final_rc, status, tmp_path):
    """A child that exits 75 under the injection, then (injection
    stripped, auto-resume set) ``final_rc``: the CLI's own exit code is
    the final child's, and its flight record holds one ``restart`` and
    ``run_end`` with the status, valid to the JAX package's schema."""
    from hydragnn_tpu.obs.flight import read_flight_record, validate_flight_record

    script, flight = tmp_path / "child.py", tmp_path / "sup.jsonl"
    script.write_text(_FLAKY_CHILD)
    proc = _supervise(["--flight", str(flight), "--", sys.executable, str(script), str(tmp_path / "m")],
                      env={"HGTORCH_INJECT_SIGTERM_EPOCH": "1", "CHILD_RC": str(final_rc)})
    assert proc.returncode == final_rc, proc.stderr[-2000:]
    events = read_flight_record(str(flight))
    assert not validate_flight_record(events)
    assert [e["kind"] for e in events] == ["run_start", "restart", "run_end"]
    assert events[1]["cause"] == "preempted" and events[1]["delay_s"] == 0.0 and events[1]["exit_code"] == 75
    assert events[-1]["status"] == status and events[-1]["preemptions"] == 1
    assert events[0]["manifest"]["supervisor"] is True
