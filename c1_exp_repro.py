#!/usr/bin/env python3
"""c1_exp_repro.py — look for the unsteady first multi-threaded torch
``exp`` (ROADMAP C1) outside pytest.

    JAX_PLATFORMS=cpu python3 c1_exp_repro.py [--procs 50] [--jobs 6]

Each of ``--procs`` fresh processes per stage runs one set-up, then the
port's SchNet Gaussian smearing (``gaussian_smearing`` of 6,000
distances into 50 Gaussians, the first multi-threaded ``torch.exp`` of
the process) twice on the default intra-op threads, then once on one
thread. The stages add one set-up call at a time, as the port's parity
tests meet them:
  - ``bare``: torch alone;
  - ``conftest``: the tests' JAX pin (``tests/conftest.py``: an 8-device
    virtual CPU mesh; imports jax);
  - ``jit``: and one jitted XLA:CPU computation;
  - ``parity``: and the JAX side of
    ``tests/test_torch_conv_stacks.py::test_stack_forward_losses_and_grads_match_jax[SchNet-False]``
    (both packages' data, the JAX model's init and its jitted gradient).
A process is "off" when its first call differs anywhere by more than
1e-6 from the call on one thread (which agrees with float64 within
1.2e-6, the rounding of the f32 arguments). Prints one line per stage
(off / runs, the worst difference, how many off processes' second call
was right) and one JSON object last.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STAGES = ("bare", "conftest", "jit", "parity")
OFF = 1e-6


def smearing_errors():
    """The first two multi-threaded smearing calls' largest differences
    from the same call on one intra-op thread (which agrees with float64
    to f32 rounding), that call's difference from float64, and the
    thread count."""
    import torch

    from hydragnn_tpu_torch.models import convs as C

    d = torch.rand(6000, generator=torch.Generator().manual_seed(0)) * 2.5
    threads = torch.get_num_threads()
    calls = [C.gaussian_smearing(d, 0.0, 2.0, 50).numpy() for _ in range(2)]
    torch.set_num_threads(1)
    one = C.gaussian_smearing(d, 0.0, 2.0, 50).numpy()
    offs = np.linspace(0.0, 2.0, 50)
    coeff = -0.5 / (2.0 / 49) ** 2
    ref = np.exp(coeff * (d.numpy().astype(np.float64)[:, None] - offs[None, :]) ** 2)
    diffs = [float(np.abs(c - one).max()) for c in calls]
    return diffs, float(np.abs(one - ref).max()), threads


def child(stage):
    sys.path.insert(0, HERE)
    if stage != "bare":
        from __graft_entry__ import _load_platform_module

        platform = _load_platform_module()
        platform.pin_virtual_cpu_mesh(8)
        platform.require_virtual_cpu_mesh(8)
    if stage in ("jit", "parity"):
        import jax
        import jax.numpy as jnp

        jax.jit(lambda a: jnp.exp(a) * 2.0)(jnp.arange(4096.0)).block_until_ready()
    if stage == "parity":
        sys.path.insert(0, os.path.join(HERE, "tests"))
        import test_torch_conv_stacks as T

        _, jcfg, _, jloader = T._both("SchNet")
        jbatch = next(iter(jloader))
        jmodel, variables = T._jax_model(jcfg, jbatch)
        out = T._jax_grad_fn(jmodel)(variables["params"], variables["batch_stats"], jbatch)
        jax.block_until_ready(out)
    diffs, one_vs_f64, threads = smearing_errors()
    print(json.dumps({"stage": stage, "first": diffs[0], "second": diffs[1], "one_thread_vs_float64": one_vs_f64,
                      "threads": threads}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=50, help="processes per stage")
    ap.add_argument("--jobs", type=int, default=6, help="processes at a time")
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--child")
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    stages = args.stages.split(",")
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def run(stage):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", stage], cwd=HERE, env=env,
                           capture_output=True, text=True, timeout=600)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            return {"stage": stage, "error": (p.stderr or p.stdout)[-400:]}
        return json.loads(lines[-1])

    summary = {}
    with ThreadPoolExecutor(args.jobs) as pool:
        for stage in stages:
            res = list(pool.map(run, [stage] * args.procs))
            ok = [r for r in res if "error" not in r]
            off = [r for r in ok if r["first"] > OFF]
            summary[stage] = {
                "runs": len(ok), "failed_to_run": len(res) - len(ok), "off": len(off),
                "worst_first": max((r["first"] for r in ok), default=None),
                "worst_one_thread_vs_float64": max((r["one_thread_vs_float64"] for r in ok), default=None),
                "off_second_right": sum(r["second"] <= OFF for r in off),
                "threads": sorted({r["threads"] for r in ok}),
            }
            print(f"[c1] stage={stage} " + " ".join(f"{k}={v}" for k, v in summary[stage].items()), flush=True)
            errors = [r["error"] for r in res if "error" in r]
            if errors:
                print(f"[c1] stage={stage} first error: {errors[0]}", flush=True)
    print(json.dumps({"procs_per_stage": args.procs, "off_above": OFF, "stages": summary}))


if __name__ == "__main__":
    main()
