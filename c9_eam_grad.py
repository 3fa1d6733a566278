"""ROADMAP C9: the first train batch's gradient of the NiNb EAM example
(``examples/eam/NiNb_EAM_bulk_multitask.json``: PNA, hidden 50, 10 layers,
edge lengths, PBC) on 640 synthetic CFG files, the set on which
``chip_smoke.py``'s ``[data-eam]`` card-against-CPU check read conv
gradients 1.1-2.7% apart (relative L2).

  JAX_PLATFORMS=cpu python3 c9_eam_grad.py --cpu [--files 640]
      The port's gradient (CPU, the kernels' plain versions) against the
      JAX package's on the same first batch and the same weights (the JAX
      package's init loaded into the port), each tensor by relative L2 and
      by ``np.allclose`` at the PNA parity tier (rtol 1e-4, atol 1e-5,
      ``tests/test_torch_train.py``); then the port against itself on the
      same graphs batched in two other orders (its own spread).

  python3 c9_eam_grad.py --card [--files 640]
      On the card: the same batch's gradient at ``[data-eam]``'s weights
      (``create_model_config(seed=1)``), with every kernel, then with each
      of B1 (and its backward), B2, B3 and B4 replaced on the card by its
      plain PyTorch version, then with all of them replaced; each against
      the CPU's plain run. Imports no JAX.

Both write the CFG files with ``chip_smoke.write_cfg_files`` (seed 0, as
``[data-eam]``) into a temporary directory and print one JSON line a
comparison."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CONFIG = os.path.join(ROOT, "examples", "eam", "NiNb_EAM_bulk_multitask.json")
PARITY_TOL = dict(rtol=1e-4, atol=1e-5)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def eam_config(cfg_dir: str) -> dict:
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["Dataset"]["path"] = {"total": cfg_dir}
    return cfg


def write_files(n_files: int) -> str:
    from chip_smoke import SEED, write_cfg_files

    d = os.path.join(tempfile.mkdtemp(prefix="c9_eam_"), "cfg")
    write_cfg_files(d, n_files, SEED)
    return d


def port_grads(model, batch):
    from hydragnn_tpu_torch.models.base import model_loss

    model.zero_grad(set_to_none=True)
    loss, _ = model_loss(model.cfg, model(batch, train=True), batch)
    loss.backward()
    return float(loss.detach()), {k: p.grad.detach().cpu().numpy() for k, p in model.named_parameters()}


def summary(label, got, ref, extra=None):
    """Each gradient's tier as ``chip_smoke.pna_step_vs_cpu`` reads it: a
    bias that feeds a BatchNorm (``convs.*.post.bias``, zero up to
    rounding) by its largest entry over its weight's; the rest by relative
    L2, conv and norm tensors apart from the heads."""
    rels, zero = {}, {}
    for k in ref:
        if k.startswith("convs.") and k.endswith("post.bias"):
            w = max(float(np.abs(ref[k[:-4] + "weight"]).max()), 1e-30)
            zero[k] = max(float(np.abs(got[k]).max()), float(np.abs(ref[k]).max())) / w
        else:
            rels[k] = rel_l2(got[k], ref[k])
    conv = {k: v for k, v in rels.items() if k.startswith(("convs.", "norms."))}
    head = {k: v for k, v in rels.items() if k not in conv}
    outside = sorted(k for k in rels if not np.allclose(got[k], ref[k], **PARITY_TOL))
    print(json.dumps({"c9": label, "tensors": len(ref), "worst_conv_rel_l2": max(conv.items(), key=lambda kv: kv[1]),
                      "worst_head_rel_l2": max(head.items(), key=lambda kv: kv[1]),
                      "worst_bn_fed_bias": max(zero.items(), key=lambda kv: kv[1]),
                      "conv_rel_l2_above_1e-2": sorted(k for k, v in conv.items() if v > 1e-2),
                      "conv_rel_l2_above_1e-4": len([v for v in conv.values() if v > 1e-4]),
                      "outside_parity_tol": len(outside), "first_outside": outside[:4],
                      "pre_bias_conv0": rels.get("convs.0.pre_bias"), **(extra or {})}), flush=True)
    return rels


def cpu_mode(n_files: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from hydragnn_tpu.api import prepare_loaders_and_config as jax_prepare
    from hydragnn_tpu.models.base import HydraModel as JaxHydraModel
    from hydragnn_tpu.models.base import model_loss as jax_model_loss
    from hydragnn_tpu.models.create import model_config_from_dict as jax_model_config

    from hydragnn_tpu_torch.api import prepare_loaders_and_config
    from hydragnn_tpu_torch.convert import variables_from_flax
    from hydragnn_tpu_torch.models.create import create_model_config

    cfg_dir = write_files(n_files)
    tl, _, _, done = prepare_loaders_and_config(eam_config(cfg_dir))
    jl, _, _, jdone = jax_prepare(eam_config(cfg_dir))
    batch, jbatch = next(iter(tl)), next(iter(jl))
    # the same graphs, real rows in the same order
    n_real = int(batch.graph_mask.sum())
    same = (n_real == int(np.asarray(jbatch.graph_mask).sum())
            and np.array_equal(batch.nodes[batch.node_mask].numpy(),
                               np.asarray(jbatch.nodes)[np.asarray(jbatch.node_mask)]))
    jmodel = JaxHydraModel(jax_model_config(jdone["NeuralNetwork"]))
    variables = jax.jit(lambda bb: jmodel.init(jax.random.PRNGKey(0), bb, train=False))(jbatch)

    def loss_fn(p):
        outs, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, jbatch, train=True,
                               mutable=["batch_stats"])
        total, _ = jax_model_loss(jmodel.cfg, outs, jbatch)
        return total

    jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    ref = {k: v.numpy() for k, v in variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, jg)}).items()}
    model = create_model_config(done["NeuralNetwork"], device="cpu")
    model.load_state_dict(variables_from_flax(variables), strict=True)
    torch.set_num_threads(1)
    loss, got = port_grads(model, batch)
    summary("port_cpu_vs_jax_cpu", got, ref,
            {"files": n_files, "graphs": n_real, "same_first_batch": bool(same), "loss_port": loss,
             "loss_jax": float(jloss), "loss_rel": abs(loss - float(jloss)) / abs(float(jloss))})
    # the port's own spread: the same graphs batched in two other orders
    # (the same sums in another order) against the first order
    idx = [int(i) for i in tl._order()[: tl.batch_size]]
    for label, order in (("reversed", idx[::-1]), ("rotated", idx[1:] + idx[:1])):
        _, spread = port_grads(model, tl.make_batch(order))
        summary(f"port_cpu_{label}_order_vs_port_cpu", spread, got, {"files": n_files})


def _swap(wrapper_mod, wrapper: str, replacement) -> list:
    """Every binding of ``wrapper_mod.wrapper``, under any name, in the
    port's loaded modules pointed at ``replacement``; returns what to
    restore."""
    fn = getattr(wrapper_mod, wrapper)
    undo = []
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("hydragnn_tpu_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            if val is fn:
                undo.append((mod, attr, fn))
                setattr(mod, attr, replacement)
    return undo


def card_mode(n_files: int) -> None:
    import subprocess

    from hydragnn_tpu_torch.api import prepare_loaders_and_config
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.ops import gather_rows as b3
    from hydragnn_tpu_torch.ops import gather_stats as b1
    from hydragnn_tpu_torch.ops import segment_sum as b2
    from hydragnn_tpu_torch.ops import segment_sum_local as b4
    from hydragnn_tpu_torch.ops._build import build_all

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    build_all(sorted({os.path.basename(m.SOURCE) for m in (b1, b2, b3, b4)}))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg_dir = write_files(n_files)
    tl, _, _, done = prepare_loaders_and_config(eam_config(cfg_dir))
    batch = next(iter(tl))
    nn = done["NeuralNetwork"]
    _, ref = port_grads(create_model_config(nn, seed=1, device="cpu"), batch)
    swaps = {
        "B1": [(b1, "gather_stats", b1.gather_stats_plain), (b1, "gather_presum_bwd", b1.gather_presum_bwd_plain)],
        "B2": [(b2, "segment_sum", b2.segment_sum_plain)],
        "B3": [(b3, "gather_rows", b3.gather_rows_plain)],
        "B4": [(b4, "segment_sum_local",
                lambda data, ids, win, n, real_edges=None: b4.segment_sum_local_plain(data, ids, n, real_edges))],
    }
    runs = [("all_kernels", [])] + [(f"{k}_plain", v) for k, v in swaps.items()] + \
        [("all_plain", [s for v in swaps.values() for s in v])]
    for label, plan in runs:
        undo = []
        for mod, wrapper, repl in plan:
            undo += _swap(mod, wrapper, repl)
        for m in (b1, b2, b3, b4):
            m.launches.reset()
        b1.bwd_launches.reset()
        try:
            model = create_model_config(nn, seed=1, device="cuda")
            loss, got = port_grads(model, batch.to("cuda"))
            counts = {"B1": b1.launches.value, "B1_bwd": b1.bwd_launches.value, "B2": b2.launches.value,
                      "B3": b3.launches.value, "B4": b4.launches.value}
        finally:
            for mod, wrapper, fn in undo:
                setattr(mod, wrapper, fn)
        summary(f"card_{label}_vs_cpu", got, ref, {"files": n_files, "loss_card": loss, "card": card,
                                                   "launches": counts})


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--cpu", action="store_true")
    g.add_argument("--card", action="store_true")
    p.add_argument("--files", type=int, default=640)
    args = p.parse_args()
    if args.card:
        if not torch.cuda.is_available():
            raise SystemExit("c9_eam_grad.py --card needs a CUDA card")
        card_mode(args.files)
    else:
        cpu_mode(args.files)


if __name__ == "__main__":
    main()
