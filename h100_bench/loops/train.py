"""Training: one loop, each step ended by a device sync.  A step builds a
fresh ``SparseConvTensor`` from the next batch of the ring, clears the
grads, runs the forward, ``loss = sum(out.float() ** 2)``, ``backward()``,
then ``p -= lr * p.grad`` in place on every parameter (the port's
``benchmark/basic.py::train_step``, copied here).

Set-up builds the one trained object and drives it through its first
``compared_steps`` steps by the window's own call, recording each loss,
each leaf's first gradient (``p.grad``) and each leaf's change; the
window goes on from there.  Once the program's state is freed, the
reference follows the same steps from the same weights on the same
batches (``harness/check.py::train_numbers``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from h100_bench.harness import check
from h100_bench.harness.window import Range, Window
from h100_bench.reference import sparse

TRAIN = True            # the net in training mode, the config's "train"
PASSES = ("forward", "dgrad", "wgrad")


def train_loss(out: torch.Tensor) -> torch.Tensor:
    """The training loss: the sum of the squared outputs, in float32."""
    return (out.float() ** 2).sum()


def sgd_update(params: List[torch.nn.Parameter], lr: float) -> None:
    """``p -= lr * p.grad`` in place."""
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.add_(p.grad, alpha=-lr)


class Loop:
    """Step ``i`` trains on ring slot ``i % ring``; returns the loss.
    While ``keep`` is set, a step also keeps its output (detached) in
    ``out``, for the check of the first step's output."""

    after = None

    def __init__(self, s):
        self.s = s
        self.params = list(s.net.parameters())
        self.lr = float(s.cfg["train"]["lr"])
        self.prog: Optional[dict] = None
        self.keep = False
        self.out: Optional[torch.Tensor] = None

    def __call__(self, i: int):
        s = self.s
        x = s.make_x(i % len(s.ring))
        for p in self.params:
            p.grad = None
        with Range("bench.forward"):
            out = s.forward(s.net, x)
        if self.keep:
            self.out = out.detach()
        with Range("bench.loss"):
            loss = train_loss(out)
        with Range("bench.backward"):
            loss.backward()
        with Range("bench.sgd"):
            sgd_update(self.params, self.lr)
        return loss.detach()

    def warm_up(self) -> int:
        """The compared first steps; returns the index of the window's
        first step."""
        self.prog = program_steps(self)
        return int(self.s.traffic["compared_steps"])

    def release(self) -> None:
        self.params = None

    def end_to_end(self, win: Window) -> Dict[str, float]:
        return {"train_scans_per_s": win.count * self.s.batch / win.seconds}

    def check(self, limits: dict):
        """``(judged, failed)``: the numbers against their limits; the run
        fails as one."""
        judged = check.judge(check.train_numbers(self.prog,
                                                 ref_steps(self.s)), limits)
        return judged, int(not all(j["ok"] for j in judged.values()))


def program_steps(loop: Loop) -> dict:
    """The first ``compared_steps`` training steps through the window's
    own call: the first step's output, each loss, each leaf's first
    gradient and its change."""
    s = loop.s
    n = int(s.traffic["compared_steps"])
    losses, grads, first = [], {}, None
    for i in range(n):
        loop.keep = i == 0
        loss = loop(i)
        s.sync()
        losses.append(float(loss))
        if i == 0:
            first = loop.out.float()
            loop.keep, loop.out = False, None
            grads = {k: p.grad.detach().float().clone()
                     for k, p in s.net.named_parameters()}
    change = {k: p.detach().float() - s.params[k].float()
              for k, p in s.net.named_parameters()}
    return {"out": first, "losses": losses, "grads": grads,
            "change": change}


def ref_steps(s, quant: Optional[str] = None, half: bool = False) -> dict:
    """The reference's first ``compared_steps`` steps from the same
    weights on the same batches, as :func:`program_steps` records them;
    with ``half``, the fault of a step that leaves out half of the batch
    and takes twice the rest."""
    n = int(s.traffic["compared_steps"])
    lr = float(s.cfg["train"]["lr"])
    params = {k: v.float().clone().requires_grad_(True)
              for k, v in s.params.items()}
    losses, grads, first = [], {}, None
    with sparse.highest():
        for i in range(n):
            slot = i % len(s.ring)
            _, f = s.ref_inputs(slot, half)
            out = s.cell.reference.forward(s.cfg, s.ref_plan(slot, half),
                                           params, f, s.bn, quant)
            if i == 0:
                first = out.detach().clone()
            loss = train_loss(out) * (2.0 if half else 1.0)
            loss.backward()
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if i == 0:
                    grads = {k: p.grad.clone() for k, p in params.items()}
                for p in params.values():
                    p -= lr * p.grad
                    p.grad = None
            del out, loss
    change = {k: p.detach() - s.params[k].float()
              for k, p in params.items()}
    return {"out": first, "losses": losses, "grads": grads,
            "change": change}


def readings(s, faults: bool) -> dict:
    """The readings of one seed (``readings.py``): the compared steps
    against the reference's, with each leaf's norms; with ``faults``, the
    float8 control in the program's place, half of the batch left out,
    and the state left unchanged (which needs no run)."""
    prog = program_steps(s.loop)
    s.free_program()
    ref = ref_steps(s)
    row = {"sound": check.train_numbers(prog, ref),
           "losses": {"program": prog["losses"],
                      "reference": ref["losses"]},
           "leaves": {k: {
               "grad": float(g.norm()),
               "grad_program": float(prog["grads"][k].norm()),
               "change": float(ref["change"][k].norm()),
               "change_program": float(prog["change"][k].norm()),
               "weight": float(s.params[k].float().norm())}
               for k, g in ref["grads"].items()}}
    if faults:
        row["control"] = check.train_numbers(ref_steps(s, quant="fp8"), ref)
        row["half_batch"] = check.train_numbers(ref_steps(s, half=True),
                                                ref)
        row["state_unchanged"] = check.train_numbers(
            dict(prog, change={k: torch.zeros_like(v)
                               for k, v in prog["change"].items()}), ref)
    return row
