"""HashTable, a fixed-capacity key -> value table (counterpart of
``spconv_tpu/hash.py``).

A sorted key array with the key dtype's max as the empty key, queried by
binary search (``torch.searchsorted``).  Operations that change the table
return a new ``HashTable`` and query-like operations return ``(values,
is_empty)``, as in the JAX package, so code written against it runs
unchanged.  int64 keys need no switch (the JAX package needs x64 on)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .core import default_device

__all__ = ["HashTable"]


class HashTable:
    """Fixed-capacity table of ``max_size`` entries on
    ``default_device(device)`` (the CUDA card unless the caller passes one;
    given ``_keys``, their device).  The live keys are sorted and occupy
    the prefix; the rest hold the empty key."""

    def __init__(self, max_size: int, key_dtype: torch.dtype = torch.int32,
                 value_dtype: torch.dtype = torch.int32,
                 _keys: Optional[torch.Tensor] = None,
                 _values: Optional[torch.Tensor] = None, device=None):
        self.max_size = int(max_size)
        self.key_dtype = key_dtype
        self.value_dtype = value_dtype
        self._empty = torch.iinfo(key_dtype).max
        if _keys is None:
            device = default_device(device)
            _keys = torch.full((self.max_size,), self._empty,
                               dtype=key_dtype, device=device)
            _values = torch.zeros(self.max_size, dtype=value_dtype,
                                  device=device)
        self.keys = _keys
        self.values = _values

    def _with(self, keys: torch.Tensor, values: torch.Tensor) -> "HashTable":
        return HashTable(self.max_size, self.key_dtype, self.value_dtype,
                         keys, values)

    def _find(self, keys: torch.Tensor):
        """``(slot, found)`` of each key: its lower bound in the table,
        clamped to the last slot, and whether that slot holds it."""
        keys = keys.to(self.keys.device, self.key_dtype)
        pos = torch.searchsorted(self.keys, keys).clamp(max=self.max_size - 1)
        return pos, self.keys[pos] == keys

    def insert(self, keys: torch.Tensor,
               values: Optional[torch.Tensor] = None) -> "HashTable":
        """A table with the pairs inserted.  For a key already present, or
        repeated in ``keys``, the first writer wins (existing entries
        first), as a hash insert.  Keys past the capacity are dropped."""
        dev = self.keys.device
        keys = keys.to(dev, self.key_dtype)
        values = (torch.zeros(keys.shape, dtype=self.value_dtype, device=dev)
                  if values is None else values.to(dev, self.value_dtype))
        all_keys = torch.cat([self.keys, keys])
        all_vals = torch.cat([self.values, values])
        sk, order = torch.sort(all_keys, stable=True)
        sv = all_vals[order]
        keep = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sk[1:] != sk[:-1]]) & (sk != self._empty)
        pos = torch.cumsum(keep, 0) - 1
        # what does not fit writes one spare slot, cut below
        pos = torch.where(keep & (pos < self.max_size), pos,
                          torch.full_like(pos, self.max_size))
        nk = torch.full((self.max_size + 1,), self._empty,
                        dtype=self.key_dtype, device=dev)
        nv = torch.zeros(self.max_size + 1, dtype=self.value_dtype,
                         device=dev)
        nk[pos] = sk
        nv[pos] = sv
        return self._with(nk[:self.max_size], nv[:self.max_size])

    def query(self, keys: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(values, is_empty)``: each key's value (0 where absent) and
        whether it is absent."""
        pos, found = self._find(keys)
        vals = torch.where(found, self.values[pos],
                           torch.zeros_like(self.values[pos]))
        return vals, ~found

    def insert_exist_keys(self, keys: torch.Tensor, values: torch.Tensor
                          ) -> Tuple["HashTable", torch.Tensor]:
        """``(table, is_empty)``: the values of the keys already present
        replaced, and which keys were absent (their values are dropped)."""
        pos, found = self._find(keys)
        nv = torch.cat([self.values, self.values.new_zeros(1)])
        nv[torch.where(found, pos, torch.full_like(pos, self.max_size))] = \
            values.to(nv.device, self.value_dtype)
        return self._with(self.keys, nv[:self.max_size]), ~found

    def assign_arange_(self) -> Tuple["HashTable", torch.Tensor]:
        """``(table, count)``: the live slots' values set to 0 .. count - 1
        in key order.  The JAX package's name; like it, this returns a new
        table and leaves this one as it is."""
        live = self.keys != self._empty
        ar = torch.cumsum(live, 0, dtype=self.value_dtype) - 1
        nv = torch.where(live, ar, self.values)
        return self._with(self.keys, nv), live.sum(dtype=torch.int32)

    def items(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(keys, values, count)``; the live entries are the prefix."""
        live = self.keys != self._empty
        return self.keys, self.values, live.sum(dtype=torch.int32)

    @property
    def size(self) -> int:
        return self.max_size
