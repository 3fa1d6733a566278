"""Bounded restart supervisor CLI (the port's copy of the JAX package's
``tools/supervise.py``; it imports no JAX): keep a training command alive
through preemptions and crashes, without looping on a run that can never
succeed (``hydragnn_tpu_torch/resilience/supervisor.py``):

    python -m hydragnn_tpu_torch.tools.supervise [options] -- python my_training_script.py ...

The child should wrap its ``run_training`` call in
``hydragnn_tpu_torch.resilience.run_guard()`` so its exits follow the
contract the supervisor classifies:

    0   completed            done
    75  preempted            restart at once (HGTORCH_AUTO_RESUME=1)
    76  rollback exhausted   FAIL FAST (a deterministic non-finite run)
    78  config error         FAIL FAST
    79  hung (watchdog)      retry with backoff
    *   crash / signal       retry with exponential backoff

Restarted children get ``HGTORCH_AUTO_RESUME=1`` and, by default, no
``HGTORCH_INJECT_*`` variable. ``--flight`` writes the supervisor's own
flight record (one ``restart`` event a re-run and a final ``run_end``)
beside the run's. ``--max-wall-s`` kills an attempt that outlives it and
counts it as hung.

``--pod N`` supervises the command as a pod of N concurrent hosts
(``resilience/supervisor.py:PodSupervisor``): each child gets its pod
identity (``HGTORCH_PODVIEW_HOST=k``, ``HGTORCH_PODVIEW_HOSTS=N``, and
with ``--run-id`` a shared ``HGTORCH_PODVIEW_RUN_ID``), the pod lives and
dies as one, and a host dead of a signal (SIGKILL, the OOM killer) is
``host_lost``: the pod restarts at once from the last committed pod
generation (``resilience/podckpt.py``). ``--pod-grace`` is the seconds the
surviving hosts get after SIGTERM to cut their last generation;
``--pod-elastic`` restarts with N-1 hosts after a loss (the restore
re-shards the committed generation onto the smaller pod).

The supervisor's own exit code is the final child's (0 when the run
completed), so wrapping scripts compose.
"""

from __future__ import annotations

import json
import os
import sys

from hydragnn_tpu_torch.obs.flight import FlightRecorder
from hydragnn_tpu_torch.resilience.supervisor import PodSupervisor, Supervisor, SupervisorPolicy, wall_clock_runner


def main(argv=None) -> int:
    import argparse

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        print("usage: python -m hydragnn_tpu_torch.tools.supervise [options] -- <command> [args...]",
              file=sys.stderr)
        return 2
    split = argv.index("--")
    opts, child = argv[:split], argv[split + 1:]
    if not child:
        print("supervise: empty child command", file=sys.stderr)
        return 2

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--max-preemptions", type=int, default=1000)
    p.add_argument("--backoff-base", type=float, default=1.0)
    p.add_argument("--backoff-factor", type=float, default=2.0)
    p.add_argument("--backoff-max", type=float, default=60.0)
    p.add_argument("--no-auto-resume", action="store_true",
                   help="do not set HGTORCH_AUTO_RESUME=1 for restarted children")
    p.add_argument("--keep-injection", action="store_true",
                   help="keep HGTORCH_INJECT_* variables across restarts (default: stripped, so an injected "
                        "fault fires once)")
    p.add_argument("--max-wall-s", type=float, default=None,
                   help="a hard wall clock an attempt: kill the child (SIGTERM, then SIGKILL) after this many "
                        "seconds and classify the attempt as hung/79")
    p.add_argument("--flight", default=None,
                   help="write the supervisor's flight record (restart events and the final summary) to this "
                        "JSONL path")
    p.add_argument("--pod", type=int, default=None, metavar="N",
                   help="supervise the command as a pod of N concurrent hosts (HGTORCH_PODVIEW_HOST=k, "
                        "HGTORCH_PODVIEW_HOSTS=N a child); the pod lives and dies as one, a host dead of a signal is "
                        "host_lost and the pod restarts at once from the last committed generation")
    p.add_argument("--pod-elastic", action="store_true",
                   help="after a host_lost attempt, restart the pod with N-1 hosts (the restore re-shards the "
                        "committed generation; pod mode)")
    p.add_argument("--pod-grace", type=float, default=30.0,
                   help="seconds the surviving hosts get after SIGTERM to cut their last generation, then SIGKILL "
                        "(pod mode)")
    p.add_argument("--run-id", default=None,
                   help="the HGTORCH_PODVIEW_RUN_ID every pod host shares (pod mode; default: each child takes "
                        "its run's log name)")
    args = p.parse_args(opts)

    policy = SupervisorPolicy(
        max_restarts=args.max_restarts,
        max_preemptions=args.max_preemptions,
        backoff_base_s=args.backoff_base,
        backoff_factor=args.backoff_factor,
        backoff_max_s=args.backoff_max,
        auto_resume=not args.no_auto_resume,
        strip_injection=not args.keep_injection,
    )
    flight = FlightRecorder(args.flight, enabled=args.flight is not None)
    # the supervisor runs no model: its run_start names the child and the policy
    flight.start_run({"supervisor": True, "argv": child, "policy": vars(args)})
    if args.pod is not None:
        sup = PodSupervisor(child, hosts=args.pod, policy=policy, env=dict(os.environ), flight=flight,
                            run_id=args.run_id, grace_s=args.pod_grace, max_wall_s=args.max_wall_s,
                            elastic=args.pod_elastic)
    else:
        runner = wall_clock_runner(args.max_wall_s) if args.max_wall_s is not None else None
        sup = Supervisor(child, policy=policy, env=dict(os.environ), flight=flight, runner=runner)
    result = sup.run()
    flight.close()
    print("supervise: " + json.dumps({k: v for k, v in result.items() if k != "history"}), file=sys.stderr)
    return int(result["exit_code"]) if result["status"] != "completed" else 0


if __name__ == "__main__":
    raise SystemExit(main())
