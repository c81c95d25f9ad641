"""The conv tuner (counterpart of ``spconv_tpu/tuner.py``): ``ConvTuner``
and the process-wide ``CONV_TUNER``.

It keeps the JAX API and its on-disk cache, ``conv_tune_cache.json`` in
``cache_dir`` (default ``constants.SPCONV_TUNE_CACHE``, the port's own
directory), keyed ``"{op}|n{bucket}|c{C}|k{K}|kv{kv}|{dtype}"`` with JAX's
dtype names (``"bfloat16"``).  Two things are tuned on the card:

* the algorithm of a conv under ``algo="auto"`` (``select_algo``,
  ``tune_conv_algo``), one winner for a forward-only call (``"algo"``) and
  one for a differentiated call (``"algo_train"``);
* B2's bf16 tile on the native path (``get_tuned_params("gather_mm",
  ...)``, ``tune_conv_tile``), the port's counterpart of the JAX package's
  gather chunk width: B2 gathers inside the GEMM, so its tile is the
  parameter the port controls.

Winners are timed with ``tools.benchmark_model`` on the live tensors.
The TPU window geometry (``get_dg_window`` / ``cache_dg_window``) has no
counterpart.
"""

from __future__ import annotations

import copy
import json
import math
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch

from .constants import SPCONV_TUNE, SPCONV_TUNE_CACHE

__all__ = ["ConvTuner", "CONV_TUNER"]


def _dtype_name(dtype) -> str:
    """JAX's name of a torch dtype (``torch.bfloat16`` -> ``"bfloat16"``),
    as the cache keys spell it; a string passes through."""
    return dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]


class ConvTuner:
    """Cached winners of the conv's tunable choices (see the module
    docstring).  The cache file is read once, at the first lookup, and
    written at every new winner."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = Path(cache_dir or SPCONV_TUNE_CACHE)
        self._cache: Dict[str, dict] = {}
        self._loaded = False
        self.force_tune = False
        # (n, c, k, kv, dtype, training, dg_supported) -> algo: what
        # resolve() found, dropped at every new winner
        self._resolved: Dict[tuple, str] = {}

    # -- persistence ----------------------------------------------------
    def _cache_file(self) -> Path:
        return self.cache_dir / "conv_tune_cache.json"

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        f = self._cache_file()
        if f.exists():
            self._cache.update(json.loads(f.read_text()))

    def _save(self) -> None:
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._cache_file().write_text(json.dumps(self._cache, indent=1))

    # -- keys -------------------------------------------------------------
    @staticmethod
    def key(op: str, n_bucket: int, c: int, k: int, kv: int,
            dtype: str) -> str:
        return f"{op}|n{n_bucket}|c{c}|k{k}|kv{kv}|{dtype}"

    @staticmethod
    def bucket_n(n: int) -> int:
        """Row counts bucketed to powers of two (at least 1,024), so one
        tuning covers a range."""
        return 1 << max(10, math.ceil(math.log2(max(n, 1))))

    def _lookup(self, op, n, c, k, kv, dtype) -> Optional[dict]:
        self._load()
        return self._cache.get(self.key(op, self.bucket_n(n), c, k, kv,
                                        _dtype_name(dtype)))

    def _store(self, op, n, c, k, kv, dtype, rec: dict) -> None:
        self._load()
        self._cache[self.key(op, self.bucket_n(n), c, k, kv,
                             _dtype_name(dtype))] = rec
        self._resolved.clear()
        self._save()

    # -- B2's tile ----------------------------------------------------------
    def get_tuned_params(self, op: str, n: int, c: int, k: int, kv: int,
                         dtype: str) -> dict:
        """The cached winner (``{"tile": i, "source": "tuned", "ms": t,
        "candidates": {...}}``),
        else ``{"tile": ops.dg_conv.b2_variant(n, c, k).tile, "source":
        "heuristic"}``: the tile B2 takes by itself.  The tile is the one
        tunable parameter, so every ``op`` has this heuristic; only bf16
        calls read it."""
        cached = self._lookup(op, n, c, k, kv, dtype)
        if cached is not None:
            return cached
        from .ops.dg_conv import b2_variant

        return {"tile": b2_variant(n, c, k).tile, "source": "heuristic"}

    def tune_and_cache(self, op: str, n: int, c: int, k: int, kv: int,
                       dtype: str, variants: Dict[str, Callable],
                       args) -> dict:
        """Times each of ``variants`` (name -> ``callable(*args)``) with
        ``tools.benchmark_model`` and caches the winner's parameters, which
        its name encodes as ``"tile=3"`` fragments (comma-separated), with
        its ms and every variant's under ``"candidates"``.  A
        variant that raises is timed as ``inf`` (with a warning); when
        every one does, it raises ``RuntimeError`` and caches nothing."""
        from .tools.timer import benchmark_model

        results = {}
        for name, fn in variants.items():
            try:
                results[name] = benchmark_model(fn, args, rep=6, n_outer=2)
            except Exception as e:  # noqa: BLE001 - a variant may not run
                warnings.warn(f"tuning {op}: variant {name} raised {e!r}; "
                              "timed as inf")
                results[name] = math.inf
        winner = min(results, key=results.get)
        if math.isinf(results[winner]):
            raise RuntimeError(f"tuning {op}: every variant raised")
        params = {"source": "tuned", "ms": results[winner],
                  "candidates": results}
        for frag in winner.split(","):
            if "=" in frag:
                key_, val = frag.split("=")
                params[key_] = int(val) if val.isdigit() else val
        self._store(op, n, c, k, kv, dtype, params)
        return params

    def tune_conv_tile(self, features: torch.Tensor,
                       weight_kv: torch.Tensor, pair_fwd: torch.Tensor,
                       subm_center: Optional[int],
                       tiles: Optional[Sequence[int]] = None) -> dict:
        """Times the native ``gather_mm`` on ``features`` ``[N_in, C]``,
        ``weight_kv`` ``[kv, C, K]`` and the rulebook table ``pair_fwd``
        ``[kv, N_out]`` on each of B2's bf16 tile variants (``tiles``,
        default all of ``ops.dg_conv.B2_TILES``) and caches the winner under
        ``"gather_mm"`` (the JAX ``tune_conv_chunk``'s counterpart).  On
        the CPU every variant is the plain version."""
        from .ops import dg_conv as D
        from .ops import gather_gemm as gg

        kv, n = pair_fwd.shape
        c, k = features.shape[1], weight_kv.shape[2]
        tiles = range(len(D.B2_TILES)) if tiles is None else tiles
        variants = {
            f"tile={t}": (lambda f, t=t: gg.gather_mm(
                f, weight_kv, pair_fwd, subm_center, tile=t))
            for t in tiles}
        return self.tune_and_cache("gather_mm", n, c, k, kv,
                                   _dtype_name(features.dtype), variants,
                                   (features,))

    # -- the algorithm of algo="auto" -----------------------------------
    @staticmethod
    def _algo_op(training: bool) -> str:
        return "algo_train" if training else "algo"

    def select_algo(self, *, subm: bool, sk_supported: bool, n: int,
                    c: int, k: int, kv: int, dtype: str,
                    backend: Optional[str] = None,
                    dg_supported: bool = False,
                    training: bool = False) -> str:
        """Resolves ``algo="auto"``: the cached winner of this signature
        (``training``: the differentiated call's), unless the layer cannot
        run it (``"sk"`` without ``sk_supported``, ``"dg"`` without
        ``dg_supported``); else the port's heuristic, ``"dg"`` where the
        dynamic-gather route serves the input and ``"native"`` elsewhere,
        on every device.  (The JAX package's rules were timed on a TPU:
        ``"sk"`` for wide training layers, ``"native"`` on the CPU; they do
        not carry over.)  ``subm`` and ``backend`` are not read.  One dict
        lookup: no device op, no sync."""
        del subm, backend
        cached = self._lookup(self._algo_op(training), n, c, k, kv, dtype)
        if cached and "algo" in cached:
            algo = cached["algo"]
            if ((algo != "sk" or sk_supported)
                    and (algo != "dg" or dg_supported)):
                return algo
        return self._heuristic(dg_supported)

    def resolve(self, conv, input, dg_supported: bool) -> str:
        """``algo="auto"`` of the conv module ``conv`` on ``input``
        (``dg_supported``: whether the DG route serves it; ``sk`` runs
        where ``dg`` does in the port).  With tuning off and nothing
        cached, the heuristic at once: no signature is built.  Else the
        winner for the call's signature, ``training`` being whether the
        call will be differentiated (grad mode is on and the weight
        requires grad): with tuning on and no winner cached, one timed by
        :meth:`tune_conv_algo` over ``"native"`` and, where the DG route
        serves, ``"sk"`` and ``"dg"``; else :meth:`select_algo`'s answer,
        remembered per signature until a new winner is cached.  No device
        op, no sync."""
        tune = self.tune_enabled
        if not tune:
            self._load()
            if not self._cache:
                return self._heuristic(dg_supported)
        n, dtype = input.indices.shape[0], input.features.dtype
        training = torch.is_grad_enabled() and conv.weight.requires_grad
        sig = (n, conv.in_channels, conv.out_channels, conv.kv, dtype,
               training, dg_supported)
        algo = None if tune else self._resolved.get(sig)
        if algo is None:
            kw = dict(n=n, c=conv.in_channels, k=conv.out_channels,
                      kv=conv.kv, dtype=dtype, training=training)
            if tune and not self.has_algo(**kw):
                cands = ["native"] + (["sk", "dg"] if dg_supported else [])
                return self.tune_conv_algo(conv, input, cands, **kw)
            algo = self._resolved[sig] = self.select_algo(
                subm=conv.subm, sk_supported=dg_supported,
                dg_supported=dg_supported, **kw)
        return algo

    @staticmethod
    def _heuristic(dg_supported: bool) -> str:
        return "dg" if dg_supported else "native"

    def cache_algo(self, *, n: int, c: int, k: int, kv: int, dtype: str,
                   algo: str, ms: Optional[float] = None,
                   training: bool = False) -> None:
        """Records a measured winner for :meth:`select_algo`."""
        rec = {"algo": algo, "source": "tuned"}
        if ms is not None:
            rec["ms"] = ms
        self._store(self._algo_op(training), n, c, k, kv, dtype, rec)

    def has_algo(self, *, n: int, c: int, k: int, kv: int, dtype: str,
                 training: bool = False) -> bool:
        rec = self._lookup(self._algo_op(training), n, c, k, kv, dtype)
        return bool(rec and "algo" in rec)

    @property
    def tune_enabled(self) -> bool:
        """Tune-on-first-call mode: ``SPCONV_TPU_TUNE=1`` (read when the
        port is imported) or ``force_tune``.  Off by default: every
        candidate runs several times on the live tensor."""
        return self.force_tune or SPCONV_TUNE

    def tune_conv_algo(self, module, input, candidates: Sequence[str], *,
                       n: int, c: int, k: int, kv: int, dtype: str,
                       timer: Optional[Callable[[str], float]] = None,
                       training: bool = False) -> str:
        """Times each of ``candidates`` (algorithm names) for ``module`` on
        the live ``input`` with ``tools.benchmark_model``, caches the
        winner for :meth:`select_algo`, with every candidate's ms under
        ``"candidates"``, and returns it.  A training key
        times the forward plus the backward with respect to the features
        and the weight.  Every call runs on a shallow copy of ``input``
        with a copy of its ``indice_dict`` (and no benchmark records), so
        no candidate leaves a record behind.  A candidate that raises is
        timed as ``inf`` (with a warning).  ``timer(algo) -> ms``
        replaces the measurement (tests)."""
        from .tools.timer import benchmark_model

        x = input.shadow_copy()
        x.benchmark = False
        results = {}
        for a in candidates:
            m = copy.copy(module)
            m.algo = a
            try:
                if timer is not None:
                    results[a] = float(timer(a))
                elif training:
                    def step(f, m=m):
                        f = f.detach().requires_grad_(True)
                        y = m(x.replace_feature(f)).features
                        return torch.autograd.grad(
                            (y.float() ** 2).sum(), (f, m.weight))

                    results[a] = benchmark_model(step, (x.features,), rep=4,
                                                 n_outer=2)
                else:
                    def fwd(f, m=m):
                        with torch.no_grad():
                            return m(x.replace_feature(f)).features

                    results[a] = benchmark_model(fwd, (x.features,), rep=4,
                                                 n_outer=2)
            except Exception as e:  # noqa: BLE001 - a candidate may not run
                warnings.warn(f"tuning {type(module).__name__}: algo {a!r} "
                              f"raised {e!r}; timed as inf")
                results[a] = math.inf
        winner = min(results, key=results.get)
        if math.isinf(results[winner]):
            raise RuntimeError(f"tuning {type(module).__name__}: every "
                               f"candidate of {list(candidates)} raised")
        self._store(self._algo_op(training), n, c, k, kv, dtype,
                    {"algo": winner, "source": "tuned",
                     "ms": results[winner], "candidates": results})
        return winner


CONV_TUNER = ConvTuner()
