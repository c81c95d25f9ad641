"""The plain match tables (B1's, ``ops/dg_conv.py``) against the JAX
package at the edge inputs of ``spconv_tpu_torch/tools/table_cases.py``:
the subm tables against the JAX ``build_dg_pos`` (its Pallas kernel in
interpret mode), the affine and divide tables against the JAX
``build_conv_rulebook``'s ``pair_fwd`` and ``pair_bwd`` on the same
output sites.  The card tests hold the kernel against these plain versions
at the same inputs; ``test_torch_table_pool_plan.py`` pins its plans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops.pallas import sorted_conv as SK
from spconv_tpu.ops.pallas.dg_conv import build_dg_pos as jax_build_dg_pos
from spconv_tpu.ops.rulebook import build_conv_rulebook

from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.ops.rulebook import build_conv_outputs
from spconv_tpu_torch.tools.table_cases import TABLE_CASES, table_case

# the cases whose reversed table is also held against JAX's: an even
# kernel (no centre, so not the forward table flipped) and a batch boundary
REVERSED = ("even", "batch_tail")


def _keys(inds, shape, batch):
    return TC.linearize(torch.from_numpy(inds), shape, batch)[0]


def _jax_subm_table(keys, shape, batch, ksize, dilation, reverse):
    """The JAX ``build_dg_pos`` table (interpret mode) as ``[kv, N]``."""
    window = 384
    deltas, _ = SK.subm_key_deltas(ksize, dilation, shape)
    groups = SK.sk_groups(ksize, include_center=True)
    sent = int(np.prod(shape)) * batch
    kj = jnp.asarray(keys.numpy())
    np_t, n_pad = SK._n_pad_for(kj.shape[0], 128, window)
    plans = SK.build_sk_plans(SK._pad_rows(kj, np_t, sent), sent, deltas,
                              groups, tile=128, window=window, n_pad=n_pad,
                              align=128)
    pos = jax_build_dg_pos(kj, plans[1 if reverse else 0], ksize=ksize,
                           dilation=dilation, spatial_shape=shape,
                           batch_size=batch, window=window, reverse=reverse,
                           interpret=True)
    kv = len(deltas)
    p = np.asarray(pos)[:, :kv, :]
    return p.transpose(1, 0, 2).reshape(kv, -1)[:, :keys.shape[0]]


@pytest.mark.parametrize("name", list(TABLE_CASES))
def test_edge_subm_tables_match_jax(name):
    """``dg_pos_plain`` is exactly the JAX table at each edge input (the
    slab's, whose windows overflow B1's pool, too), reversed as well at
    the cases of ``REVERSED``."""
    inds, shape, batch, subm, _ = table_case(name)
    keys = _keys(inds, shape, batch)
    for ksize, dil in subm:
        for reverse in (False, True) if name in REVERSED else (False,):
            got = TD.dg_pos_plain(keys, ksize=ksize, dilation=dil,
                                  spatial_shape=shape, batch_size=batch,
                                  reverse=reverse)
            want = _jax_subm_table(keys, shape, batch, ksize, dil, reverse)
            np.testing.assert_array_equal(got.numpy(), want)
            assert (got[:, (inds[:, 0] < 0)] == -1).all()


@pytest.mark.parametrize("name", list(TABLE_CASES))
def test_edge_regular_tables_match_jax(name):
    """``dg_pos_affine_plain`` and ``dg_pos_divide_plain`` are exactly the
    JAX regular-conv rulebook's ``pair_fwd`` and ``pair_bwd`` on the same
    output sites, at each edge input and conv (even kernels, dilation 2 on
    the fastest axis, probes off every face, ndim 1-4)."""
    inds, shape, batch, _, regular = table_case(name)
    keys = _keys(inds, shape, batch)
    bound = inds.shape[0]
    for ksize, stride, padding, dil in regular:
        geom = dict(ksize=ksize, stride=stride, padding=padding,
                    dilation=dil)
        _, out_keys, _, _ = build_conv_outputs(
            torch.from_numpy(inds), spatial_shape=shape, batch_size=batch,
            out_bound=bound, **geom)
        rb = build_conv_rulebook(jnp.asarray(inds), spatial_shape=shape,
                                 batch_size=batch, out_bound=bound, **geom)
        out_shape = tuple(TC.get_conv_output_size(shape, ksize, stride,
                                                  padding, dil))
        tgeom = dict(geom, in_shape=shape, out_shape=out_shape,
                     batch_size=batch)
        aff = TD.dg_pos_affine_plain(keys, out_keys, **tgeom)
        div = TD.dg_pos_divide_plain(keys, out_keys, **tgeom)
        np.testing.assert_array_equal(aff.numpy(), np.asarray(rb.pair_fwd))
        np.testing.assert_array_equal(div.numpy(), np.asarray(rb.pair_bwd))
        assert (aff >= 0).any()
