"""Containers, feature-wise wrappers and normalization (counterpart of
``spconv_tpu/modules/modules.py``): ``SparseSequential``, ``Lambda``,
``SparseIdentity`` / ``Identity``, ``SparseReLU``, ``SparseLeakyReLU``,
``SparseSigmoid``, ``BatchNorm1d`` / ``SparseBatchNorm`` with its
running-stat update and ``SparseSyncBatchNorm`` (its statistics summed
across the ranks of a mesh axis), ``ToDense``, the debug passthroughs
``PrintTensorMeta`` / ``PrintCurrentTime``,
``assign_name_for_sparse_modules``, and the per-layer benchmark records
(:func:`record_benchmark_layer`, :func:`run_layer`).

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
from ..ops.batch_norm import batch_norm_train, batch_stats
from ..tracing import span

__all__ = ["SparseModule", "SparseSequential", "Lambda", "SparseIdentity",
           "Identity", "SparseReLU", "SparseLeakyReLU", "SparseSigmoid",
           "BatchNorm1d", "SparseBatchNorm", "SparseSyncBatchNorm",
           "ToDense", "PrintTensorMeta", "PrintCurrentTime",
           "assign_name_for_sparse_modules", "record_benchmark_layer",
           "run_layer"]


class SparseModule(nn.Module):
    """Marker: the module takes and returns a :class:`SparseConvTensor`."""


def record_benchmark_layer(out: SparseConvTensor, name: str,
                           module: nn.Module, *, n_in=None, n_out=None,
                           num_pairs=None, time_ms=None) -> None:
    """Adds one record to ``out.benchmark_record`` under ``name`` (then
    ``name#1``, ``name#2``, ... when taken): the JAX package's record, with
    ``"layer"``, ``"type"`` (the module's class name),
    ``"num_voxels_in"``, ``"num_voxels_out"`` and ``"num_pairs"`` (ints,
    read on the host, or None), ``"time_ms"`` (float or None) and those of
    the module's ``in_channels``, ``out_channels``, ``kernel_size``,
    ``stride``, ``algo`` and ``indice_key`` that it has."""

    def _int(v):
        return None if v is None else int(v)

    rec = {
        "layer": name,
        "type": type(module).__name__,
        "num_voxels_in": _int(n_in),
        "num_voxels_out": _int(n_out),
        # the matched (input, output) pairs: the layer's MACs are
        # num_pairs * C_in * C_out
        "num_pairs": _int(num_pairs),
        "time_ms": None if time_ms is None else float(time_ms),
    }
    for attr in ("in_channels", "out_channels", "kernel_size", "stride",
                 "algo", "indice_key"):
        if hasattr(module, attr):
            rec[attr] = getattr(module, attr)
    key, i = name, 1
    while key in out.benchmark_record:
        key = f"{name}#{i}"
        i += 1
    out.benchmark_record[key] = rec


def run_layer(module: nn.Module, input: SparseConvTensor,
              *args) -> SparseConvTensor:
    """``module._forward(input, *args)``, a conv's or pool's forward, under
    the layer's name (``module.name`` or its class name).

    While a profiler records, the call runs inside a
    ``torch.profiler.record_function(name)`` range (the JAX package's
    ``jax.named_scope``; :func:`tracing.span`), a host event around the
    layer's device ops and its ``spconv.*`` spans.  Under
    ``input.benchmark`` the output carries the producer's records and adds
    the layer's own (:func:`record_benchmark_layer`): its ``time_ms`` is
    the time between two CUDA events around the call, read after a sync at
    its end (on the CPU, the host clock), and its ``num_pairs`` is
    ``module._num_pairs(input, out)`` where the module has one.  Otherwise
    it adds no device op, no sync and no allocation: the profiler check is
    one boolean."""
    name = module.name or type(module).__name__
    if not input.benchmark:
        with span(name):
            return module._forward(input, *args)
    cuda = input.features.is_cuda
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    with span(name):
        out = module._forward(input, *args)
    if cuda:
        end.record()
        end.synchronize()
        time_ms = start.elapsed_time(end)
    else:
        time_ms = (time.perf_counter() - t0) * 1e3
    out.benchmark = True
    for k, v in input.benchmark_record.items():
        out.benchmark_record.setdefault(k, v)
    pairs = getattr(module, "_num_pairs", None)
    record_benchmark_layer(
        out, name, module, n_in=input.num_voxels, n_out=out.num_voxels,
        num_pairs=None if pairs is None else pairs(input, out),
        time_ms=time_ms)
    return out


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

    Training and :meth:`updated` run :mod:`ops.batch_norm`'s ops (on the
    card its CUDA kernels, ``csrc/bn.cu``; on the CPU their plain
    versions): the masked count, sum and sum of squares in f64, the
    normalization, and a closed-form backward that saves the input, the
    mask, the mean and rstd.  Eval mode normalizes with plain torch ops:
    no benchmark or exported net runs it (served nets fold BN into the
    convs), so the C++ op library needs no BN op.

    With ``axis_name`` (SyncBN), the packed f64 ``[2C + 1]`` count, sum
    and sum of squares are all-reduced across the ranks of the process
    group that ``parallel.make_mesh`` registered under that axis, and the
    backward's f64 ``[2C]`` sums likewise before the input gradient (the
    JAX ``psum`` and its transpose): training normalizes with the global
    statistics and :meth:`updated` advances the running ones by them.  In
    eval mode there is no collective.  An axis with no group raises
    ``RuntimeError`` in training; it never falls back to the local
    statistics.

    Takes a :class:`SparseConvTensor` or a plain ``[N, C]`` tensor (all
    rows active).  On the card, training and :meth:`updated` take f32,
    bf16 or fp16 features and int32 indices (the kernels' types; a
    :class:`SparseConvTensor`'s indices are int32) and raise on any other;
    on the CPU the plain versions take f64 features and other integer
    indices too.  Eval mode takes any float dtype on either.  ``device``
    None is the CUDA card.  ``forward`` runs in the ``spconv.bn`` span
    (:mod:`tracing`), and so does its backward."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 axis_name: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, device=None,
                 name: Optional[str] = None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.axis_name = axis_name
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
        axis = (f", axis_name={self.axis_name!r}" if self.axis_name
                else "")
        return f"{self.num_features}, eps={self.eps}{axis}"

    def _group(self):
        """The process group of ``axis_name``, None without one."""
        if self.axis_name is None:
            return None
        from ..parallel.mesh import axis_group

        return axis_group(self.axis_name)

    def forward(self, x: Union[SparseConvTensor, torch.Tensor]
                ) -> Union[SparseConvTensor, torch.Tensor]:
        sparse = isinstance(x, SparseConvTensor)
        feats = x.features if sparse else x
        with span("spconv.bn"):
            if self.training:
                out = batch_norm_train(feats, x.indices if sparse else None,
                                       self.weight, self.bias, self.eps,
                                       self._group())
                return x.replace_feature(out) if sparse else out
            out = ((feats.float() - self.running_mean)
                   * torch.rsqrt(self.running_var + self.eps))
            if self.weight is not None:
                out = out * self.weight + self.bias
            out = out.to(feats.dtype)
            return x.replace_feature_masked(out) if sparse else out

    @torch.no_grad()
    def updated(self, x: Union[SparseConvTensor, torch.Tensor]
                ) -> "BatchNorm1d":
        """Advances the running statistics by the batch ``x``'s masked
        ones, in place: ``running = (1 - momentum) * running + momentum *
        batch``, with the unbiased variance ``var * cnt / max(cnt - 1,
        1)``.  Returns ``self`` (the JAX ``updated`` returns a new
        module)."""
        sparse = isinstance(x, SparseConvTensor)
        mean, var, cnt = batch_stats(x.features if sparse else x,
                                     x.indices if sparse else None,
                                     self._group())
        unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
        mom = self.momentum
        self.running_mean.copy_((1 - mom) * self.running_mean + mom * mean)
        self.running_var.copy_((1 - mom) * self.running_var + mom * unbiased)
        return self


class SparseBatchNorm(BatchNorm1d):
    """:class:`BatchNorm1d` under the reference's name."""


class SparseSyncBatchNorm(BatchNorm1d):
    """:class:`BatchNorm1d` whose statistics are summed across the ranks
    of ``axis_name`` (default ``"dp"``, the axis ``parallel.make_mesh``
    registers by default): the reference's ``SparseSyncBatchNorm``, which
    wraps ``torch.nn.SyncBatchNorm``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 axis_name: str = "dp", dtype: torch.dtype = torch.float32,
                 device=None, name: Optional[str] = None):
        super().__init__(num_features, eps, momentum, affine, axis_name,
                         dtype, device, name)


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
