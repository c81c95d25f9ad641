"""Conv epilogues (counterpart of ``spconv_tpu/ops/epilogue.py``): bias,
residual add and activation, in the reference's fused order
``act(conv + bias + add_input)``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["Activation", "apply_act", "bias_add_act"]


class Activation:
    NONE = "none"
    RELU = "relu"
    SIGMOID = "sigmoid"
    LEAKY_RELU = "leaky_relu"


def apply_act(x: torch.Tensor, act_type: Optional[str],
              act_alpha: float = 0.0, act_beta: float = 0.0) -> torch.Tensor:
    if act_type in (None, Activation.NONE):
        return x
    if act_type == Activation.RELU:
        return F.relu(x)
    if act_type == Activation.SIGMOID:
        return torch.sigmoid(x)
    if act_type == Activation.LEAKY_RELU:
        return F.leaky_relu(x, act_alpha)
    raise NotImplementedError(act_type)


def bias_add_act(
    out: torch.Tensor,
    bias: Optional[torch.Tensor],
    act_type: Optional[str] = Activation.NONE,
    act_alpha: float = 0.0,
    act_beta: float = 0.0,
    add_input: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """bias -> residual add -> activation."""
    if bias is not None:
        out = out + bias
    if add_input is not None:
        out = out + add_input.to(out.dtype)
    return apply_act(out, act_type, act_alpha, act_beta)
