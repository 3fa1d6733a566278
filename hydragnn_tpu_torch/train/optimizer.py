"""Optimizer selection (the port's counterpart of
``hydragnn_tpu/train/optimizer.py``).

The JAX package picks one of eight optax optimizers, with optax's
defaults. Five of them ``torch.optim`` computes with optax's formula,
and the port uses torch's class for those:

  ============  ==========================================================
  SGD           ``torch.optim.SGD``
  Adam          ``torch.optim.Adam``, b1 0.9, b2 0.999, eps 1e-8
  AdamW         ``torch.optim.AdamW``, the same and weight decay 1e-4
                (torch's own default is 1e-2)
  Adadelta      ``torch.optim.Adadelta``, rho 0.9, eps 1e-6
  Adamax        ``torch.optim.Adamax``, b1 0.9, b2 0.999, eps 1e-8
  ============  ==========================================================

On the card Adam and AdamW run fused and Adadelta and Adamax
capturable, so their step counts stay on the device; on the CPU they
take torch's default path. The other three are written here after
optax's source (``_OptaxRule``), because torch lacks them or computes
them otherwise:

  ============  ==========================================================
  Adagrad       ``s = s + g²`` from ``s = 0.1``,
                ``u = g/√(s + 1e-7)`` where ``s > 0`` (torch: eps
                outside the root)
  RMSprop       ``v = 0.9·v + 0.1·g²``, ``u = g/√(v + 1e-8)`` (torch:
                decay 0.99, eps outside the root)
  FusedLAMB     Adam's ``u`` with eps 1e-6, times the trust ratio
                ``‖p‖/‖u‖`` of each tensor (1 where either norm is 0)
  ============  ==========================================================

then ``p += -lr·u``. A parameter without a gradient takes a zero one,
as optax sees every leaf. Every state tensor exists from the start, on
the parameters' device on the card, so the guarded train step
(``train/state.py``) keeps or restores the whole state on the device
without a host synchronisation.

``Architecture.freeze_conv_layers`` puts the encoder convs' parameters
(``convs.*``, the JAX package's ``conv_*`` subtrees, ``convert.py``) in
a parameter group of their own with learning rate 0, which the plateau
scheduler leaves alone. That is optax's ``masked(set_to_zero)`` after
the rule: the frozen parameters' moments still follow their gradients,
their values do not move. BatchNorm and head parameters keep training.

``Training.grad_accum_steps = k`` is ``optax.MultiSteps``: the running
mean of the micro-batch gradients, ``acc += (g - acc)/(i + 1)``, feeds
the rule, whose new parameters and state are kept on every k-th step
only (selected on the device). The learning rate is read and set
through ``param_groups`` whatever wraps the rule; it is held as given,
a Python float, where optax holds its float32 rounding.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

OPTIMIZERS = ("SGD", "Adam", "Adadelta", "Adagrad", "Adamax", "AdamW", "RMSprop", "FusedLAMB")

_ADAM = dict(betas=(0.9, 0.999), eps=1e-8)
# the torch class of each rule torch computes as optax does, its
# arguments for optax's defaults, and its flag for a count on the card
_TORCH = {
    "SGD": (torch.optim.SGD, {}, None),
    "Adam": (torch.optim.Adam, _ADAM, "fused"),
    "AdamW": (torch.optim.AdamW, dict(_ADAM, weight_decay=1e-4), "fused"),
    "Adadelta": (torch.optim.Adadelta, dict(rho=0.9, eps=1e-6), "capturable"),
    "Adamax": (torch.optim.Adamax, _ADAM, "capturable"),
}
_FLAGS = ("fused", "capturable", "foreach")

# optax's state slot -> the state key of the rule that keeps it
SLOTS: Dict[str, Dict[str, str]] = {
    "SGD": {},
    "Adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "AdamW": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "Adadelta": {"e_g": "square_avg", "e_x": "acc_delta"},
    "Adamax": {"mu": "exp_avg", "nu": "exp_inf"},
    "Adagrad": {"sum_of_squares": "sum_of_squares"},
    "RMSprop": {"nu": "nu"},
    "FusedLAMB": {"mu": "mu", "nu": "nu"},
}
# the state key of the rule's count: torch's ``step``, or optax's
# ``count`` for LAMB (a float32 tensor of each parameter either way)
COUNT = {"Adam": "step", "AdamW": "step", "Adadelta": "step", "Adamax": "step", "FusedLAMB": "count"}
_INIT = {"sum_of_squares": 0.1}  # optax's Adagrad accumulator starts at 0.1; every other slot at 0
B1, B2 = 0.9, 0.999


def _ema(values: List[torch.Tensor], moment: List[torch.Tensor], decay: float) -> List[torch.Tensor]:
    """optax's ``update_moment``: ``(1 - decay)·values + decay·moment``."""
    return torch._foreach_add(torch._foreach_mul(values, 1 - decay), torch._foreach_mul(moment, decay))


def keep_where(cond: torch.Tensor, tensors: List[torch.Tensor], snap: List[torch.Tensor]) -> None:
    """Put ``snap`` back into ``tensors`` where the device flag ``cond``
    holds, in place and without a host synchronisation."""
    for t, s in zip(tensors, snap):
        torch.where(cond, s, t, out=t)


def snapshot(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """A copy of every tensor, the floating ones in one multi-tensor
    launch (x·1 keeps every bit, -0.0 and NaN too)."""
    floats = [t for t in tensors if t.is_floating_point()]
    copies = iter(torch._foreach_mul(floats, 1.0) if floats else ())
    return [next(copies) if t.is_floating_point() else t.clone() for t in tensors]


class _OptaxRule(torch.optim.Optimizer):
    """optax's Adagrad, RMSprop and LAMB as multi-tensor ops in optax's
    order of operations, one parameter group at a time."""

    def __init__(self, groups, kind: str, lr: float):
        super().__init__(groups, dict(lr=lr))
        self.kind = kind

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("this optimizer takes no closure")
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            grads = [p.grad for p in params]
            st = [self.state[p] for p in params]
            upd = self._update(grads, params, st)
            torch._foreach_add_(params, torch._foreach_mul(upd, -group["lr"]))

    def _update(self, grads, params, st, write: bool = True) -> List[torch.Tensor]:
        """The rule's ``u``; the new state is written unless ``write`` is
        false (``Optimizer.dry_update``)."""
        F = torch
        if self.kind == "Adagrad":
            sos = F._foreach_add(F._foreach_mul(grads, grads), [s["sum_of_squares"] for s in st])
            if write:
                torch._foreach_copy_([s["sum_of_squares"] for s in st], sos)
            inv = [torch.where(t > 0, torch.rsqrt(t + 1e-7), torch.zeros_like(t)) for t in sos]
            return F._foreach_mul(inv, grads)
        if self.kind == "RMSprop":
            nu = _ema(F._foreach_mul(grads, grads), [s["nu"] for s in st], 0.9)
            if write:
                torch._foreach_copy_([s["nu"] for s in st], nu)
            return F._foreach_mul(F._foreach_rsqrt(F._foreach_add(nu, 1e-8)), grads)
        # FusedLAMB: optax's scale_by_adam (eps 1e-6), weight decay 0, the trust ratio
        counts = [s["count"] for s in st]
        c = counts[0] + 1.0
        mu = _ema(grads, [s["mu"] for s in st], B1)
        nu = _ema(F._foreach_mul(grads, grads), [s["nu"] for s in st], B2)
        if write:
            torch._foreach_add_(counts, 1.0)
            torch._foreach_copy_([s["mu"] for s in st], mu)
            torch._foreach_copy_([s["nu"] for s in st], nu)
        m_hat = F._foreach_div(mu, 1.0 - B1 ** c)
        v_hat = F._foreach_div(nu, 1.0 - B2 ** c)
        upd = F._foreach_div(m_hat, F._foreach_add(F._foreach_sqrt(v_hat), 1e-6))
        upd = F._foreach_add(upd, F._foreach_mul(params, 0.0))
        # a sharded layout reduces the norms over each tensor's shards (parallel/sharded.py)
        norms = getattr(self, "tensor_norms", None)
        pn, un = (norms(params, params), norms(upd, params)) if norms else (F._foreach_norm(params), F._foreach_norm(upd))
        return [u * torch.where((a == 0.0) | (b == 0.0), torch.ones_like(a), a / b) for u, a, b in zip(upd, pn, un)]


def _torch_direction(kind: str, params, grads, st) -> List[torch.Tensor]:
    """``u`` of the torch rule ``kind`` (``p += -lr·u``) from its state
    ``st``, which stays as it is, in torch's order of operations."""
    F = torch
    kw = _TORCH[kind][1]
    if kind == "SGD":
        return list(grads)
    if kind == "Adadelta":
        rho, eps = kw["rho"], kw["eps"]
        sq = F._foreach_addcmul(F._foreach_mul([s["square_avg"] for s in st], rho), grads, grads, value=1 - rho)
        delta = F._foreach_div(F._foreach_sqrt(F._foreach_add([s["acc_delta"] for s in st], eps)),
                               F._foreach_sqrt(F._foreach_add(sq, eps)))
        return F._foreach_mul(delta, grads)
    (b1, b2), eps = kw["betas"], kw["eps"]
    # the parameters step together: one count; the bias corrections in
    # float64, as torch's step takes them from its count on the CPU
    t = st[0]["step"].double() + 1.0
    m = F._foreach_lerp([s["exp_avg"] for s in st], grads, 1 - b1)
    if kind == "Adamax":
        inf = F._foreach_maximum(F._foreach_mul([s["exp_inf"] for s in st], b2),
                                 F._foreach_add(F._foreach_abs(grads), eps))
        return F._foreach_div(F._foreach_div(m, inf), 1 - b1 ** t)
    v = F._foreach_addcmul(F._foreach_mul([s["exp_avg_sq"] for s in st], b2), grads, grads, value=1 - b2)
    denom = F._foreach_add(F._foreach_div(F._foreach_sqrt(v), (1 - b2 ** t).sqrt()), eps)
    u = F._foreach_div(F._foreach_div(m, denom), 1 - b1 ** t)
    # AdamW decays the parameter by lr·wd before the step: wd·p in u
    return F._foreach_add(u, list(params), alpha=kw.get("weight_decay", 0.0)) if kind == "AdamW" else u


class Optimizer:
    """One of ``OPTIMIZERS`` with optax's update rule and defaults, the
    freeze mask and the gradient accumulation (module docstring).

    Args:
      params: the parameters, in the model's ``named_parameters`` order.
      kind: one of ``OPTIMIZERS``.
      lr: the learning rate.
      frozen: a flag per parameter; a frozen parameter's update is zero.
      accum: micro-batches per update (``grad_accum_steps``).

    ``inner`` is the ``torch.optim.Optimizer`` that applies the rule;
    ``param_groups`` and ``state`` are its own (the frozen parameters,
    if any, are the second group). ``steps`` counts the train steps that
    landed (the JAX package's ``TrainState.step``; the train step
    advances it). ``state_dict`` holds the rule's, the accumulation's
    step counters under ``"shared"``, and ``steps``."""

    def __init__(self, params, kind: str, lr: float, frozen: Optional[Sequence[bool]] = None, accum: int = 1):
        if kind not in OPTIMIZERS:
            raise NameError(f"The string used to identify the optimizer is not recognized: {kind}")
        if accum < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {accum}")
        plist = list(params)
        frozen = [False] * len(plist) if frozen is None else [bool(f) for f in frozen]
        if len(frozen) != len(plist):
            raise ValueError("frozen needs one flag per parameter")
        self.kind = kind
        self.accum = int(accum)
        lr = float(lr)
        groups = [{"params": [p for p, f in zip(plist, frozen) if not f], "lr": lr}]
        if any(frozen):
            groups.append({"params": [p for p, f in zip(plist, frozen) if f], "lr": 0.0, "frozen": True})
        dev = plist[0].device if plist else torch.device("cpu")
        if kind in _TORCH:
            cls, kw, on_card = _TORCH[kind]
            flag = {on_card: True} if on_card and dev.type == "cuda" else {}
            self.inner: torch.optim.Optimizer = cls(groups, lr=lr, **kw, **flag)
        else:
            self.inner = _OptaxRule(groups, kind, lr)
        self._flags = {k: self.inner.param_groups[0][k] for k in _FLAGS if k in self.inner.param_groups[0]}
        count = COUNT.get(kind)
        count_dev = dev if kind not in _TORCH or self._flags.get("fused") or self._flags.get("capturable") else "cpu"
        for p in self._params():  # every state tensor before the first step (torch makes them lazily)
            st = self.state[p]
            for key in SLOTS[kind].values():
                st[key] = torch.full_like(p, _INIT.get(key, 0.0), memory_format=torch.preserve_format)
            if count is not None:
                st[count] = torch.zeros((), dtype=torch.float32, device=count_dev)
            if self.accum > 1:
                st["acc"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        self.shared: Dict[str, torch.Tensor] = {}
        if self.accum > 1:
            self.shared["mini_step"] = zero.clone()
            self.shared["gradient_step"] = zero.clone()
        self.steps = zero.clone()

    @property
    def param_groups(self) -> List[Dict[str, Any]]:
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    def count(self) -> Optional[torch.Tensor]:
        """The rule's count (optax's ``count``, torch's ``step``), or None."""
        key, params = COUNT.get(self.kind), self._params()
        return None if key is None or not params else self.state[params[0]][key]

    def _rule_tensors(self) -> List[torch.Tensor]:
        return [st[k] for p in self._params() for st in (self.state[p],) for k in sorted(st) if k != "acc"]

    def state_tensors(self) -> List[torch.Tensor]:
        """Every state tensor, in a fixed order (the guarded step keeps
        them on a bad batch)."""
        acc = [self.state[p]["acc"] for p in self._params()] if self.accum > 1 else []
        return self._rule_tensors() + acc + [self.shared[k] for k in sorted(self.shared)]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> Dict[str, Any]:
        return {"rule": self.inner.state_dict(), "shared": {k: v.clone() for k, v in self.shared.items()},
                "steps": self.steps.clone()}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        shared = state_dict["shared"]
        if set(shared) != set(self.shared):
            raise ValueError(f"optimizer state holds {sorted(shared)}, this optimizer {sorted(self.shared)}")
        self.inner.load_state_dict(state_dict["rule"])
        # torch takes the saved groups' flags: keep this device's, and
        # its count where they keep it
        count, dev = COUNT.get(self.kind), self.steps.device
        for g in self.param_groups:
            g.update(self._flags)
        for p in self._params():
            st = self.state[p]
            if count is not None:
                on_card = self.kind not in _TORCH or self._flags.get("fused") or self._flags.get("capturable")
                st[count] = st[count].to(device=p.device if on_card else "cpu", dtype=torch.float32)
        for k, v in shared.items():
            self.shared[k].copy_(v)
        self.steps.copy_(state_dict["steps"].to(dev))

    @torch.no_grad()
    def dry_update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """What ``step()`` would add to each of ``params`` (any order) for
        ``grads``, read from the state, which stays as it is (the per-head
        diagnostics' update norm): the rule's formula in its order of
        operations, the accumulation's mean and emit, the freeze mask. It
        matches a real step's change up to rounding."""
        grads = [g.to(p.dtype) for p, g in zip(params, grads)]
        st = [self.state[p] for p in params]
        emit = None
        if self.accum > 1:
            mini = self.shared["mini_step"]
            acc = [s["acc"] for s in st]
            grads = torch._foreach_add(acc, torch._foreach_div(torch._foreach_sub(grads, acc),
                                                               (mini + 1).to(grads[0].dtype)))
            emit = mini == self.accum - 1
        if self.kind in _TORCH:
            u = _torch_direction(self.kind, params, grads, st)
        else:
            u = self.inner._update(grads, params, st, write=False)
        lr = {id(p): g["lr"] for g in self.param_groups for p in g["params"]}
        upd = torch._foreach_mul(u, [-lr[id(p)] for p in params])
        return upd if emit is None else [torch.where(emit, d, torch.zeros_like(d)) for d in upd]

    @torch.no_grad()
    def step(self) -> None:
        params = self._params()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.accum == 1:
            self.inner.step()
            return
        mini = self.shared["mini_step"]
        grads = [p.grad for p in params]
        acc = [self.state[p]["acc"] for p in params]
        mean = torch._foreach_add(acc, torch._foreach_div(torch._foreach_sub(grads, acc),
                                                          (mini + 1).to(grads[0].dtype)))
        emit = mini == self.accum - 1
        kept = params + self._rule_tensors()
        snap = snapshot(kept)
        for p, m in zip(params, mean):
            p.grad = m
        self.inner.step()
        keep_where(~emit, kept, snap)
        torch._foreach_copy_(acc, torch._foreach_mul(mean, (~emit).to(grads[0].dtype)))
        step = self.shared["gradient_step"]
        torch.where(emit, step + 1, step, out=step)
        mini.copy_((mini + 1) % self.accum)


def select_optimizer(model: torch.nn.Module, training_config: Dict[str, Any],
                     freeze_conv: bool = False) -> Optimizer:
    """The optimizer of the ``Training`` config section over ``model``'s
    parameters; ``freeze_conv`` (``Architecture.freeze_conv_layers``)
    masks the encoder convs' updates."""
    opt_cfg = training_config.get("Optimizer", {})
    opt_type = opt_cfg.get("type", "AdamW")
    lr = float(opt_cfg.get("learning_rate", training_config.get("learning_rate", 1e-3)))
    named = list(model.named_parameters())
    frozen = [freeze_conv and name.startswith("convs.") for name, _ in named]
    return Optimizer([p for _, p in named], opt_type, lr, frozen=frozen,
                     accum=int(training_config.get("grad_accum_steps", 1)))


def current_learning_rate(optimizer: Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        if not group.get("frozen"):
            group["lr"] = float(lr)
