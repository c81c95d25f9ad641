"""Containers, feature-wise wrappers and normalization (counterpart of
``spconv_tpu/modules/modules.py``): ``SparseSequential``, ``Lambda``,
``SparseIdentity`` / ``Identity``, ``SparseReLU``, ``SparseLeakyReLU``,
``SparseSigmoid``, ``BatchNorm1d`` / ``SparseBatchNorm`` with its
running-stat update, ``ToDense``, the debug passthroughs
``PrintTensorMeta`` / ``PrintCurrentTime`` and
``assign_name_for_sparse_modules``.  ``SparseSyncBatchNorm`` (the JAX
package's cross-device BN) is not ported yet.

The modules that the JAX package names (those that keep a ``name``
attribute) keep one here, ``None`` by default, so that
:func:`assign_name_for_sparse_modules` names a net as the JAX function
names the same net."""

from __future__ import annotations

import time
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core import SparseConvTensor, default_device

__all__ = ["SparseModule", "SparseSequential", "Lambda", "SparseIdentity",
           "Identity", "SparseReLU", "SparseLeakyReLU", "SparseSigmoid",
           "BatchNorm1d", "SparseBatchNorm", "ToDense", "PrintTensorMeta",
           "PrintCurrentTime", "assign_name_for_sparse_modules"]


class SparseModule(nn.Module):
    """Marker: the module takes and returns a :class:`SparseConvTensor`."""


def _featurewise(x, fn: Callable):
    """``fn`` of the features of ``x`` (a :class:`SparseConvTensor`, with
    inactive rows set back to 0 for ops where ``f(0) != 0``) or of ``x``
    itself (a plain tensor)."""
    if isinstance(x, SparseConvTensor):
        return x.replace_feature_masked(fn(x.features))
    return fn(x)


def apply_layer(layer: nn.Module, x: SparseConvTensor):
    """One layer of a :class:`SparseSequential`: a :class:`SparseModule`
    receives the tensor; any other module receives ``x.features``, and its
    result replaces them, inactive rows set back to 0."""
    if isinstance(layer, SparseModule):
        return layer(x)
    return x.replace_feature_masked(layer(x.features))


class Lambda(SparseModule):
    """A feature-wise callable as a module: ``fn`` of the features, with
    inactive rows set back to 0 (or of a plain tensor)."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        super().__init__()
        self.fn = fn
        self.name = name

    def forward(self, x):
        return _featurewise(x, self.fn)


class SparseSequential(SparseModule):
    """Sequential container of sparse modules and dense feature ops.

    A :class:`SparseModule` receives the tensor.  Any other module receives
    ``x.features``; its result replaces the features, with inactive rows
    set back to 0 (for ops where ``f(0) != 0``).  A bare callable that is
    not a module is wrapped in :class:`Lambda`.  Positional layers are
    registered as ``"0"``, ``"1"``, ..., named ones under their names (a
    JAX ``SparseSequential``'s state-dict keys ``layers.<i>.`` load into
    them, ``checkpoint.load_jax_state_dict``)."""

    def __init__(self, *layers, **named_layers):
        super().__init__()
        for i, layer in enumerate(layers):
            self.add_module(str(i), _as_module(layer))
        for name, layer in named_layers.items():
            self.add_module(name, _as_module(layer))

    def __getitem__(self, i: int) -> nn.Module:
        return list(self._modules.values())[i]

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def add(self, layer, name: Optional[str] = None) -> "SparseSequential":
        """A new container with ``layer`` appended (under ``name`` when
        given), sharing this one's layers (the JAX ``add``)."""
        new = SparseSequential()
        for key, m in self._modules.items():
            new.add_module(key, m)
        new.add_module(str(len(new)) if name is None else name,
                       _as_module(layer))
        return new

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        for layer in self._modules.values():
            x = apply_layer(layer, x)
        return x


def _as_module(layer) -> nn.Module:
    return layer if isinstance(layer, nn.Module) else Lambda(layer)


class SparseIdentity(SparseModule):
    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name

    def forward(self, x):
        return x


Identity = SparseIdentity


class BatchNorm1d(SparseModule):
    """Feature-row batch norm whose statistics cover active rows only (a
    dense BN over the padded buffer would count the zero padding).

    In training mode (``module.train()``) it normalizes with the masked
    batch statistics, otherwise with the running ones.  Statistics and the
    normalization are f32; the result is cast back to the features' dtype
    and inactive rows are 0.  Its tensors are exactly the JAX module's
    leaves, ``weight``, ``bias`` (parameters, when ``affine``),
    ``running_mean`` and ``running_var`` (f32 buffers), so a JAX state
    dict loads strictly; there is no ``num_batches_tracked``.  As in the
    JAX package, ``forward`` never changes the running statistics:
    :meth:`updated` advances them by a batch.

    Takes a :class:`SparseConvTensor` or a plain ``[N, C]`` tensor (all
    rows active).  ``device`` None is the CUDA card."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 name: Optional[str] = None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.name = name
        device = default_device(device)
        if affine:
            self.weight = nn.Parameter(
                torch.ones(num_features, dtype=dtype, device=device))
            self.bias = nn.Parameter(
                torch.zeros(num_features, dtype=dtype, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def extra_repr(self) -> str:
        return f"{self.num_features}, eps={self.eps}"

    @staticmethod
    def _feats_mask(x):
        if isinstance(x, SparseConvTensor):
            return x.features, x.valid_mask
        return x, torch.ones(x.shape[0], dtype=torch.bool, device=x.device)

    @staticmethod
    def _batch_stats(feats, mask):
        """f32 ``(mean, biased var, count)`` over the rows of ``mask``
        (count at least 1)."""
        m = mask[:, None].float()
        f32 = feats.float() * m
        cnt = m.sum().clamp(min=1.0)
        mean = f32.sum(0) / cnt
        var = (f32 * f32).sum(0) / cnt - mean * mean
        return mean, var.clamp(min=0.0), cnt

    def forward(self, x: Union[SparseConvTensor, torch.Tensor]
                ) -> Union[SparseConvTensor, torch.Tensor]:
        feats, mask = self._feats_mask(x)
        if self.training:
            mean, var, _ = self._batch_stats(feats, mask)
        else:
            mean, var = self.running_mean, self.running_var
        out = (feats.float() - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            out = out * self.weight + self.bias
        out = out.to(feats.dtype)
        if isinstance(x, SparseConvTensor):
            return x.replace_feature_masked(out)
        return out

    @torch.no_grad()
    def updated(self, x: Union[SparseConvTensor, torch.Tensor]
                ) -> "BatchNorm1d":
        """Advances the running statistics by the batch ``x``'s masked
        ones, in place: ``running = (1 - momentum) * running + momentum *
        batch``, with the unbiased variance ``var * cnt / max(cnt - 1,
        1)``.  Returns ``self`` (the JAX ``updated`` returns a new
        module)."""
        mean, var, cnt = self._batch_stats(*self._feats_mask(x))
        unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
        mom = self.momentum
        self.running_mean.copy_((1 - mom) * self.running_mean + mom * mean)
        self.running_var.copy_((1 - mom) * self.running_var + mom * unbiased)
        return self


class SparseBatchNorm(BatchNorm1d):
    """:class:`BatchNorm1d` under the reference's name."""


class SparseReLU(SparseModule):
    """ReLU of the features (any dtype, int8 included); inactive rows stay
    0."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name

    def forward(self, x):
        if isinstance(x, SparseConvTensor):
            return x.replace_feature(torch.relu(x.features))
        return torch.relu(x)


class SparseLeakyReLU(SparseModule):
    def __init__(self, negative_slope: float = 0.01,
                 name: Optional[str] = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.name = name

    def forward(self, x):
        return _featurewise(
            x, lambda f: F.leaky_relu(f, self.negative_slope))


class SparseSigmoid(SparseModule):
    """Sigmoid of the features; inactive rows stay 0 (not 0.5)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name

    def forward(self, x):
        return _featurewise(x, torch.sigmoid)


class ToDense(SparseModule):
    """Densify to ``[B, C, *spatial]`` (:meth:`SparseConvTensor.dense`)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name

    def forward(self, x: SparseConvTensor) -> torch.Tensor:
        return x.dense()


class PrintTensorMeta(SparseModule):
    """Debug passthrough printing the feature shape and the active count
    (reads the count on the host, so it syncs)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name

    def forward(self, x):
        if isinstance(x, SparseConvTensor):
            print(f"SparseConvTensor feat_shape={tuple(x.features.shape)} "
                  f"num_voxels={int(x.num_voxels)}")
        return x


class PrintCurrentTime(SparseModule):
    """Debug passthrough printing the wall-clock time."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name

    def forward(self, x):
        print(f"[spconv_tpu_torch] {time.strftime('%H:%M:%S')}")
        return x


def assign_name_for_sparse_modules(module: nn.Module) -> None:
    """Names every module of ``module``'s tree that keeps a ``name``
    attribute and has none, ``f"{type name}_{n}"`` with one counter over
    the tree, in pre-order (``module.modules()``): the JAX function's
    order, which visits attributes as they were set."""
    n = 0
    for m in module.modules():
        if "name" in vars(m) and m.name is None:
            m.name = f"{type(m).__name__}_{n}"
            n += 1
