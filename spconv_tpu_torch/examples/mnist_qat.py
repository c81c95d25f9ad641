"""Whole-net QAT on the sparse MNIST-style classifier (counterpart of
``examples/mnist_qat.py``): float pretraining -> ``prepare_qat`` ->
fake-quant fine-tuning -> ``convert_qat`` -> int8 inference on kernel B7,
against observe-only PTQ.

Flow (scale EMAs and BN statistics advance in place inside the training
step, ``quantization.qat``)::

    enc   = float encoder (SparseSequential) + pool + fp head
    qnet  = prepare_qat(enc)            # QATQuantStub + fused QATConvBnReLU
    qat_observe(qnet, x)                # scale EMA, every QAT step
    ...train...
    int8  = convert_qat(qnet)           # deployable QuantizedSequential

The three nets are evaluated on the same 8 batches.

Usage: python -m spconv_tpu_torch.examples.mnist_qat [--steps 30]
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core import SparseConvTensor, default_device
from ..modules import (BatchNorm1d, SparseConv2d, SparseGlobalAvgPool,
                       SparseReLU, SparseSequential, SubMConv2d)
from ..quantization import convert_qat, prepare_qat, qat_observe
from .mnist_sparse import ce, make_batch

__all__ = ["FLOAT_LR", "QAT_LR", "OBSERVE_BATCHES", "EVAL_BATCHES",
           "build_net", "logits_of", "ce", "float_step", "qat_step",
           "accuracy", "main"]

FLOAT_LR = 3e-3
QAT_LR = 5e-4
OBSERVE_BATCHES = 8  # observe-only calibration batches (PTQ)
EVAL_BATCHES = 8

Head = Tuple[torch.Tensor, torch.Tensor]


def build_net(device=None, seed: int = 0
              ) -> Tuple[SparseSequential, SparseGlobalAvgPool, Head]:
    """The float encoder ``SubMConv2d(1, 32) -> BN -> ReLU ->
    SparseConv2d(32, 64, s2, p1) -> BN -> ReLU`` (convs without bias), the
    global average pool and the head ``(w [64, 10], b [10])``, f32,
    weights drawn from ``seed`` on the CPU.  ``device`` None is the CUDA
    card."""
    device = default_device(device)
    gen = torch.Generator().manual_seed(seed)
    kw = dict(bias=False, device=device, generator=gen)
    enc = SparseSequential(
        SubMConv2d(1, 32, 3, indice_key="s1", **kw),
        BatchNorm1d(32, device=device),
        SparseReLU(),
        SparseConv2d(32, 64, 3, stride=2, padding=1, **kw),
        BatchNorm1d(64, device=device),
        SparseReLU(),
    )
    bound = 1.0 / math.sqrt(64)
    w = torch.empty((64, 10)).uniform_(-bound, bound, generator=gen)
    head = (w.to(device).requires_grad_(),
            torch.zeros(10, device=device, requires_grad=True))
    return enc, SparseGlobalAvgPool(), head


def logits_of(enc: torch.nn.Module, pool: SparseGlobalAvgPool, head: Head,
              x: SparseConvTensor) -> torch.Tensor:
    """``pool(enc(x)) @ w + b``: the float, the QAT or the int8 net."""
    w, b = head
    return pool(enc(x)) @ w + b


def float_step(enc: SparseSequential, pool: SparseGlobalAvgPool,
               head: Head, opt: torch.optim.Optimizer, x: SparseConvTensor,
               y: torch.Tensor) -> torch.Tensor:
    """One optimizer step of the float net on ``ce``; the step's grads
    stay on the parameters.  Returns the loss (0-d, on the device)."""
    opt.zero_grad(set_to_none=True)
    loss = ce(logits_of(enc, pool, head, x), y)
    loss.backward()
    opt.step()
    return loss.detach()


def qat_step(qnet: SparseSequential, pool: SparseGlobalAvgPool, head: Head,
             opt: torch.optim.Optimizer, x: SparseConvTensor,
             y: torch.Tensor) -> torch.Tensor:
    """One QAT step: :func:`qat_observe` on ``x`` (scale EMAs, BN
    statistics), then one optimizer step of the fake-quantized net on
    ``ce``.  Returns the loss."""
    qat_observe(qnet, x)
    return float_step(qnet, pool, head, opt, x, y)


@torch.no_grad()
def accuracy(net: torch.nn.Module, pool: SparseGlobalAvgPool, head: Head,
             batches: Sequence[Tuple[SparseConvTensor, torch.Tensor]]
             ) -> float:
    """Mean over ``batches`` of each batch's accuracy (one sync)."""
    accs = [(logits_of(net, pool, head, x).argmax(-1) == y).float().mean()
            for x, y in batches]
    return float(torch.stack(accs).mean())


def main(device=None, steps: int = 30, seed: int = 0) -> Dict[str, object]:
    """The whole flow on :func:`make_batch` batches from
    ``RandomState(seed)``: ``steps`` float steps (Adam, ``FLOAT_LR``, BN on
    batch statistics), PTQ (``OBSERVE_BATCHES`` observe-only batches,
    ``convert_qat``), ``steps`` QAT steps (Adam, ``QAT_LR``, from the PTQ
    net and a copy of the head), ``convert_qat``, and the three accuracies
    on the same ``EVAL_BATCHES`` batches.  Returns the losses, the
    accuracies and the nets."""
    device = default_device(device)
    rng = np.random.RandomState(seed)
    enc, pool, head = build_net(device, seed)

    # ---- 1. float pretraining ----------------------------------------
    enc.train()
    opt = torch.optim.Adam(list(enc.parameters()) + list(head), lr=FLOAT_LR)
    losses_float: List[float] = []
    for _ in range(steps):
        x, y = make_batch(rng, device=device)
        losses_float.append(float_step(enc, pool, head, opt, x, y))
    enc.eval()
    print(f"float pretrain done: loss {float(losses_float[-1]):.4f}")

    # ---- 2. PTQ baseline: observe-only calibration --------------------
    qnet = prepare_qat(enc)
    for _ in range(OBSERVE_BATCHES):
        qat_observe(qnet, make_batch(rng, device=device)[0])
    int8_ptq = convert_qat(qnet)

    # ---- 3. QAT fine-tune (scale EMA inside the step) -----------------
    qhead = tuple(t.detach().clone().requires_grad_() for t in head)
    qnet.train()
    qopt = torch.optim.Adam(list(qnet.parameters()) + list(qhead),
                            lr=QAT_LR)
    losses_qat: List[float] = []
    for _ in range(steps):
        x, y = make_batch(rng, device=device)
        losses_qat.append(qat_step(qnet, pool, qhead, qopt, x, y))
    int8_qat = convert_qat(qnet)
    print(f"QAT fine-tune done: loss {float(losses_qat[-1]):.4f}")

    # ---- 4. evaluate float vs PTQ-int8 vs QAT-int8 --------------------
    batches = [make_batch(rng, device=device) for _ in range(EVAL_BATCHES)]
    accs = dict(float=accuracy(enc, pool, head, batches),
                ptq_int8=accuracy(int8_ptq, pool, head, batches),
                qat_int8=accuracy(int8_qat, pool, qhead, batches))
    print(f"accuracy: float {accs['float']:.3f} | PTQ int8 "
          f"{accs['ptq_int8']:.3f} | QAT int8 {accs['qat_int8']:.3f}")
    return dict(losses_float=[float(v) for v in losses_float],
                losses_qat=[float(v) for v in losses_qat], accuracy=accs,
                enc=enc, pool=pool, head=head, qnet=qnet, qhead=qhead,
                int8_ptq=int8_ptq, int8_qat=int8_qat)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    main(steps=ap.parse_args().steps)
