"""``debug_utils.spconv_save_debug_data`` of the port against the JAX
package's: with ``SPCONV_TPU_DEBUG_SAVE_PATH`` set, both pickle the same
array (dtype, shape and values) for the same indices; without it, neither
writes anything."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu import debug_utils as jax_debug

from spconv_tpu_torch import constants
from spconv_tpu_torch import debug_utils

from utils import generate_sparse_data


def _indices(seed):
    _, inds = generate_sparse_data((9, 10, 11), 50, 3, batch_size=2,
                                   rng=np.random.RandomState(seed))
    return inds


@pytest.mark.parametrize("seed", [0, 1])
def test_save_debug_data_matches_jax(tmp_path, monkeypatch, seed):
    """The port's pickle (from a torch tensor) loads to the JAX function's
    array (from a JAX array) for the same indices."""
    inds = _indices(seed)
    monkeypatch.setattr(constants, "SPCONV_DEBUG_SAVE_PATH",
                        str(tmp_path / "port"))
    monkeypatch.setattr(jax_debug, "SPCONV_DEBUG_SAVE_PATH",
                        str(tmp_path / "jax"))
    got = debug_utils.spconv_save_debug_data(torch.from_numpy(inds))
    want = jax_debug.spconv_save_debug_data(jnp.asarray(inds))
    assert got.startswith(str(tmp_path / "port" / "spconv_tpu_debug_"))
    with open(got, "rb") as f:
        a = pickle.load(f)
    with open(want, "rb") as f:
        b = pickle.load(f)
    assert isinstance(a, np.ndarray) and a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, inds)


def test_save_debug_data_off_without_the_flag(tmp_path, monkeypatch):
    """No directory named: ``""``, and nothing written."""
    monkeypatch.setattr(constants, "SPCONV_DEBUG_SAVE_PATH", "")
    monkeypatch.chdir(tmp_path)
    assert debug_utils.spconv_save_debug_data(
        torch.from_numpy(_indices(0))) == ""
    assert not any(tmp_path.iterdir())
