"""The port's spans and its table counter (``spconv_tpu_torch.tracing``)
on the CPU: under a profiler a small net's forward and backward open the
``spconv.*`` spans in the documented order, each phase span inside its
layer's range and the gradients' spans inside autograd's backward, on the
DG path, the native path (rows not key-sorted) and in search mode (subm
convs without a key); with no profiler no range is constructed; and
``table_counts`` counts each table built and reused."""

import numpy as np
import pytest
import torch

import spconv_tpu_torch as st
from spconv_tpu_torch import tracing
from spconv_tpu_torch.ops import dg_conv as TD

from utils import generate_sparse_data, pad_sparse

SHAPE = (9, 10, 11)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel may launch."""
    TD.reset_launch_counts()
    yield
    assert not any(TD.launch_counts.values())


class Net(torch.nn.Module):
    """Two subm convs under one key (or none), BN between them, a strided
    conv with a key and its inverse conv, a 2x max pool and ``dense()``."""

    def __init__(self, key):
        super().__init__()
        torch.manual_seed(0)
        self.sub_a = st.SubMConv3d(4, 8, 3, indice_key=key, name="sub_a",
                                   device="cpu")
        self.bn = st.BatchNorm1d(8, device="cpu")
        self.sub_b = st.SubMConv3d(8, 8, 3, indice_key=key, name="sub_b",
                                   device="cpu")
        self.down = st.SparseConv3d(8, 8, 3, stride=2, padding=1,
                                    indice_key="d2", name="down",
                                    device="cpu")
        self.up = st.SparseInverseConv3d(8, 8, 3, indice_key="d2",
                                         name="up", device="cpu")
        self.pool = st.SparseMaxPool3d(2, 2, name="pool")

    def forward(self, x):
        x = self.sub_b(self.bn(self.sub_a(x)))
        x = self.up(self.down(x))
        return self.pool(x).dense()


def _input(sorted_rows: bool):
    rng = np.random.RandomState(3)
    feats, inds = generate_sparse_data(SHAPE, 120, 4, batch_size=2, rng=rng)
    fp, ip = pad_sparse(feats, inds, 280)
    x = st.SparseConvTensor(torch.from_numpy(fp), torch.from_numpy(ip),
                            SHAPE, 2)
    if sorted_rows:
        return x.sort_by_key()
    order = torch.from_numpy(np.random.RandomState(4).permutation(280))
    return x.select_by_index(order)


def _step(net, x):
    net(x).float().pow(2).sum().backward()


def _layer(name, *phases):
    return [name, *(f"spconv.{p}" for p in phases)]


# the ranges each case opens in its forward, in order; a layer's name is
# followed by its phase spans
FORWARD = {
    "dg": [*_layer("sub_a", "rulebook", "product", "epilogue"),
           "spconv.bn",
           *_layer("sub_b", "product", "epilogue"),
           # discovery, then the affine table and the divide table
           *_layer("down", "rulebook", "rulebook", "rulebook", "product",
                   "epilogue"),
           *_layer("up", "product", "epilogue"),
           *_layer("pool", "rulebook", "pool"),
           "spconv.dense"],
    "native": [*_layer("sub_a", "rulebook", "product", "epilogue"),
               "spconv.bn",
               *_layer("sub_b", "product", "epilogue"),
               *_layer("down", "rulebook", "product", "epilogue"),
               *_layer("up", "product", "epilogue"),
               *_layer("pool", "rulebook", "pool"),
               "spconv.dense"],
    "search": [*_layer("sub_a", "rulebook", "product", "epilogue"),
               "spconv.bn",
               *_layer("sub_b", "rulebook", "product", "epilogue"),
               *_layer("down", "rulebook", "rulebook", "rulebook",
                       "product", "epilogue"),
               *_layer("up", "product", "epilogue"),
               *_layer("pool", "rulebook", "pool"),
               "spconv.dense"],
}
# the backward's: the four convs in reverse, BN's backward between sub_b's
# and sub_a's, sub_a with no input gradient (its dgrad span holds the cast
# of dout alone)
BACKWARD = (["spconv.dgrad", "spconv.wgrad"] * 3 + ["spconv.bn"]
            + ["spconv.dgrad", "spconv.wgrad"])

CASES = {"dg": ("s1", True), "native": ("s1", False),
         "search": (None, True)}

# (subm, regular, native) built and reused, and pools built, of one step
COUNTS = {
    "dg": {"subm.built": 1, "subm.reused": 1, "regular.built": 1,
           "regular.reused": 1, "native.built": 0, "native.reused": 0,
           "pool.built": 1},
    "native": {"subm.built": 0, "subm.reused": 0, "regular.built": 0,
               "regular.reused": 0, "native.built": 2, "native.reused": 2,
               "pool.built": 1},
    "search": {"subm.built": 0, "subm.reused": 0, "regular.built": 1,
               "regular.reused": 1, "native.built": 0, "native.reused": 0,
               "pool.built": 1},
}

LAYERS = ("sub_a", "sub_b", "down", "up", "pool")


def _spied(run):
    """``run()`` with every ``record_function`` constructed recorded by
    name, in order."""
    opened = []
    real = torch.profiler.record_function

    class Spy(real):
        def __init__(self, name, *a, **k):
            opened.append(name)
            super().__init__(name, *a, **k)

    torch.profiler.record_function = Spy
    try:
        run()
    finally:
        torch.profiler.record_function = real
    return opened


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_order_and_nesting(case):
    """Under a CPU profiler one training step opens the layer ranges and
    ``spconv.*`` spans in the documented order; each phase span's parent is
    its layer's range, BN's and dense's are outside every layer, and the
    gradients' spans sit inside an autograd backward node."""
    key, sorted_rows = CASES[case]
    net, x = Net(key), _input(sorted_rows)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])

    def run():
        with prof:
            _step(net, x)

    opened = _spied(run)
    assert opened == FORWARD[case] + BACKWARD
    layer = None
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name in LAYERS:
            layer = e.name
        if not e.name.startswith("spconv."):
            continue
        parent = e.cpu_parent
        if e.name in ("spconv.dgrad", "spconv.wgrad"):
            names = []
            while parent is not None:
                names.append(parent.name)
                parent = parent.cpu_parent
            assert any("Backward" in n for n in names), (e.name, names)
            assert not set(names) & set(LAYERS)
        elif e.name in ("spconv.bn", "spconv.dense"):
            assert parent is None or parent.name not in LAYERS
        else:
            assert parent is not None and parent.name == layer, (
                e.name, parent and parent.name, layer)


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_range_without_profiler(case):
    """With the profiler off the same step constructs no
    ``record_function``: each span is the shared no-op context."""
    key, sorted_rows = CASES[case]
    net, x = Net(key), _input(sorted_rows)
    assert _spied(lambda: _step(net, x)) == []
    assert tracing.span("spconv.bn") is tracing.span("spconv.pool")


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_counts(case):
    """One step counts each table built and reused exactly: a keyed subm
    stage builds once and is reused by its second conv, the strided conv's
    record is built once and reused by its inverse, a keyless subm conv
    counts nothing; ``reset_table_counts`` zeroes every count."""
    key, sorted_rows = CASES[case]
    net, x = Net(key), _input(sorted_rows)
    tracing.reset_table_counts()
    _step(net, x)
    assert tracing.table_counts == COUNTS[case]
    tracing.reset_table_counts()
    assert set(tracing.table_counts.values()) == {0}


def test_serving_counts_per_request():
    """Under ``torch.no_grad()`` a fresh tensor per request builds its
    tables anew: two requests count twice one request's."""
    net, x = Net("s1").eval(), _input(True)
    tracing.reset_table_counts()
    with torch.no_grad():
        net(x)
        once = dict(tracing.table_counts)
        net(_input(True))
    assert once["subm.built"] == once["regular.built"] == 1
    assert tracing.table_counts == {k: 2 * v for k, v in once.items()}
