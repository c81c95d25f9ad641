"""The native rulebook path of the PyTorch port against the JAX package on
the CPU: ``ops.gather_gemm`` (``indice_conv`` forward and ``torch.autograd``
against ``jax.grad``, and its three public functions), the conv modules on
it (``algo="native"``, and ``"auto"`` on input whose rows are in no key
order), the native pools, the int8 native route, the core leftovers
(``from_dense``, ``select_by_index``, ``scatter_nd``), a grid past 2**31
sites, and the slice as a whole: a small net of BenchNet's shape on
``algo="native"`` and the small ``SparseUNet`` on unsorted input.  On the
CPU the port's wrappers take their plain versions; the kernels are held
against those on the card in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.checkpoint import state_dict
from spconv_tpu.core import scatter_nd as jax_scatter_nd
from spconv_tpu.ops import gather_gemm as JG
from spconv_tpu.ops import rulebook as JR
from spconv_tpu.quantization import quantize as jq

import spconv_tpu_torch as st
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.core import IndiceData
from spconv_tpu_torch.modules.conv import DGData
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.ops import gather_gemm as TG
from spconv_tpu_torch.ops import rulebook as TR
from spconv_tpu_torch.quantization import quantize as tq

from utils import generate_sparse_data

SHAPE = (10, 12, 14)
NBUF = 256
FWD_TOL = 1e-5   # f32 forward, of max|ref|: sums in another order
GRAD_TOL = 5e-5  # f32 grads, of max|ref| per tensor (ROADMAP.md)
# the int8 native route against the JAX package's: its epilogue rounds
# (acc * s_in * s_w + b) / s_out, the port's acc * (s_in * s_w / s_out) +
# b / s_out, which may land one step away at a tie
INT8_STEPS, INT8_SHARE = 1, 0.01


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel may launch."""
    TD.reset_launch_counts()
    yield
    assert not any(TD.launch_counts.values())


def _input(seed, c, shape=SHAPE, batch=1, n=120, nbuf=NBUF, integer=False):
    """Seeded features and coordinates of ``n`` sites per batch item in
    ``nbuf`` rows in a random order (inactive rows among them);
    ``integer``: small integer features, so a max pool meets ties."""
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(shape, n, c, batch_size=batch,
                                       rng=rng)
    if integer:
        feats = rng.randint(-3, 4, size=feats.shape).astype(np.float32)
    fb = np.zeros((nbuf, c), np.float32)
    ib = np.full((nbuf, len(shape) + 1), -1, np.int32)
    fb[:len(inds)] = feats
    ib[:len(inds)] = inds
    perm = rng.permutation(nbuf)
    return fb[perm], ib[perm]


def _tensors(feats, inds, shape=SHAPE, batch=1, sorted_=False):
    return (spconv_tpu.SparseConvTensor(
                jnp.asarray(feats), jnp.asarray(inds), shape, batch,
                keys_sorted=sorted_),
            st.SparseConvTensor(torch.from_numpy(feats),
                                torch.from_numpy(inds), shape, batch,
                                keys_sorted=sorted_))


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def _seq_pair(jlayers, tlayers):
    """A JAX ``SparseSequential`` and the port's with its weights."""
    jseq = spconv_tpu.SparseSequential(*jlayers)
    tseq = st.SparseSequential(*tlayers)
    sd = {k.replace("layers.", ""): v for k, v in state_dict(jseq).items()}
    return jseq, load_jax_state_dict(tseq, sd, strict=False)


def _run_pair(jseq, tseq, feats, inds, shape=SHAPE, batch=1, seed=9):
    """Forward of both nets and the grads of ``sum(out * cot)`` with
    respect to the input features and every parameter; checks sites and
    counts exactly and every float within its tolerance.  Returns the
    port's output."""
    jx, tx = _tensors(feats, inds, shape, batch)
    tx = tx.replace_feature(tx.features.clone().requires_grad_())
    y = tseq(tx)
    cot = np.random.RandomState(seed).randn(*y.features.shape)
    cot = (cot * (y.indices.numpy()[:, :1] >= 0)).astype(np.float32)
    (y.features * torch.from_numpy(cot)).sum().backward()

    def loss(tree):
        m, f = tree
        out = m(jx.replace_feature(f))
        return jnp.sum(out.features * cot), out

    (_, ref), (gm, gf) = spconv_tpu.filter_value_and_grad(
        loss, has_aux=True)((jseq, jnp.asarray(feats)))
    np.testing.assert_array_equal(y.indices.numpy(), np.asarray(ref.indices))
    assert tuple(y.spatial_shape) == tuple(ref.spatial_shape)
    assert int(y.num_voxels) == int(ref.num_voxels)
    assert y.keys_sorted == ref.keys_sorted
    _close(y.features, ref.features, FWD_TOL)
    _close(tx.features.grad, gf, GRAD_TOL)
    g_ref = {k.replace("layers.", ""): v
             for k, v in state_dict(gm).items()}
    for name, p in tseq.named_parameters():
        _close(p.grad, g_ref[name], GRAD_TOL)
    return y


# ---------------------------------------------------------------------------
# ops.gather_gemm
# ---------------------------------------------------------------------------

def _rulebook(kind, inds):
    """The JAX and port rulebooks of one conv kind and the rows its
    features live on."""
    kw = dict(spatial_shape=SHAPE, batch_size=1)
    if kind == "subm":
        kw.update(ksize=(3, 3, 3), dilation=(1, 1, 1))
        return (JR.build_subm_rulebook(jnp.asarray(inds), **kw),
                TR.build_subm_rulebook(torch.from_numpy(inds), **kw))
    kw.update(ksize=(3, 3, 3), stride=(2, 2, 2), padding=(1, 1, 1),
              dilation=(1, 1, 1))
    if kind == "transposed":
        kw.update(ksize=(2, 2, 2), padding=(0, 0, 0), transposed=True,
                  out_bound=1024)
    return (JR.build_conv_rulebook(jnp.asarray(inds), **kw),
            TR.build_conv_rulebook(torch.from_numpy(inds), **kw))


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse",
                                  "transposed"])
def test_indice_conv_matches_jax(kind):
    """``indice_conv`` forward within 1e-5 and its grads (din, dW) within
    5e-5 of max|ref| against ``jax.grad`` of the JAX ``indice_conv``; an
    inverse conv runs on the strided rulebook's swapped tables."""
    c, k_out = 4, 6
    _, inds = _input(0, c)
    jrec, trec = _rulebook("strided" if kind == "inverse" else kind, inds)
    jf, jb = jrec.pair_fwd, jrec.pair_bwd
    tf, tb = trec.pair_fwd, trec.pair_bwd
    if kind == "inverse":
        jf, jb, tf, tb = jb, jf, tb, tf
    rng = np.random.RandomState(1)
    ksize = (2, 2, 2) if kind == "transposed" else (3, 3, 3)
    # inactive rows hold 0, the framework's invariant (the JAX subm conv's
    # centre offset is a plain matmul over every row)
    rows_in, rows_out = trec.indices, trec.out_indices
    if kind == "inverse":
        rows_in, rows_out = rows_out, rows_in
    feats = (rng.randn(tb.shape[1], c)
             * (rows_in[:, :1].numpy() >= 0)).astype(np.float32)
    w = (rng.randn(k_out, *ksize, c) / 10).astype(np.float32)
    cot = (rng.randn(tf.shape[1], k_out)
           * (rows_out[:, :1].numpy() >= 0)).astype(np.float32)
    is_subm = kind == "subm"

    def loss(f, wt):
        out = JG.indice_conv(f, wt, jf, jb, is_subm=is_subm)
        return jnp.sum(out * cot), out

    (_, ref), (gf, gw) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(w))
    x = torch.from_numpy(feats).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = TG.indice_conv(x, wt, tf, tb, is_subm=is_subm)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, ref, FWD_TOL)
    _close(x.grad, gf, GRAD_TOL)
    _close(wt.grad, gw, GRAD_TOL)
    with pytest.raises(NotImplementedError, match="fp32_accum"):
        TG.indice_conv(x, wt, tf, tb, is_subm=is_subm, fp32_accum=False)


def test_gather_functions_match_jax():
    """``gather_mm``, ``dgrad_gather_mm`` and ``wgrad_gather_mm`` (over
    ``pair_bwd`` and over ``pair_fwd``) on a strided rulebook, and
    ``wgrad_gather_mm`` over a 2x pool rulebook, whose tables are not
    mirrors, against the JAX functions, f32 within 1e-5 of max|ref|."""
    c, k_out = 5, 3
    _, inds = _input(2, c)
    jrec, trec = _rulebook("strided", inds)
    rng = np.random.RandomState(3)
    wkv = rng.randn(27, c, k_out).astype(np.float32)
    x = rng.randn(NBUF, c).astype(np.float32)
    dout = rng.randn(trec.pair_fwd.shape[1], k_out).astype(np.float32)
    tw, tx, td = (torch.from_numpy(a) for a in (wkv, x, dout))
    _close(TG.gather_mm(tx, tw, trec.pair_fwd, None),
           JG.gather_mm(jnp.asarray(x), jnp.asarray(wkv), jrec.pair_fwd,
                        None), FWD_TOL)
    _close(TG.dgrad_gather_mm(td, tw, trec.pair_bwd, None),
           JG.dgrad_gather_mm(jnp.asarray(dout), jnp.asarray(wkv),
                              jrec.pair_bwd, None), FWD_TOL)
    want = JG.wgrad_gather_mm(jnp.asarray(x), jnp.asarray(dout),
                              jrec.pair_fwd, None)
    for pair_bwd in (None, trec.pair_bwd):
        _close(TG.wgrad_gather_mm(tx, td, trec.pair_fwd, None,
                                  pair_bwd=pair_bwd), want, FWD_TOL)
    kw = dict(spatial_shape=SHAPE, batch_size=1)
    jp = JR.build_pool2_rulebook(jnp.asarray(inds), **kw)
    tp = TR.build_pool2_rulebook(torch.from_numpy(inds), **kw)
    dp = rng.randn(NBUF, k_out).astype(np.float32)
    _close(TG.wgrad_gather_mm(tx, torch.from_numpy(dp), tp.pair_fwd, None),
           JG.wgrad_gather_mm(jnp.asarray(x), jnp.asarray(dp), jp.pair_fwd,
                              None), FWD_TOL)


# ---------------------------------------------------------------------------
# the conv modules
# ---------------------------------------------------------------------------

def _convs(kind, algo):
    """Layer lists (JAX, port) ending in a conv of ``kind``."""
    def pair(cls, *a, **kw):
        return (getattr(spconv_tpu, cls)(*a, algo=algo, **kw),
                getattr(st, cls)(*a, algo=algo, device="cpu", **kw))

    layers = {
        "subm": [pair("SubMConv3d", 4, 6, 3, indice_key="a")],
        "strided": [pair("SubMConv3d", 4, 6, 3, indice_key="a"),
                    pair("SparseConv3d", 6, 5, 3, stride=2, padding=1,
                         indice_key="d")],
        "inverse": [pair("SparseConv3d", 4, 6, 3, stride=2, padding=1,
                         indice_key="d"),
                    pair("SparseInverseConv3d", 6, 5, 3, indice_key="d")],
        "transposed": [pair("SparseConvTranspose3d", 4, 5, 2, stride=2)],
    }[kind]
    return [j for j, _ in layers], [t for _, t in layers]


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse",
                                  "transposed"])
def test_native_convs_match_jax(kind):
    """Each conv on ``algo="native"`` in both packages, on input whose rows
    are in no key order: sites, counts and ``keys_sorted`` exactly,
    features within 1e-5 and every grad within 5e-5 of max|ref|; each
    keyed layer leaves an ``IndiceData`` under its key."""
    feats, inds = _input(4, 4)
    y = _run_pair(*_seq_pair(*_convs(kind, "native")), feats, inds)
    for key in {"subm": ["a"], "strided": ["a", "d"], "inverse": ["d"],
                "transposed": []}[kind]:
        assert isinstance(y.indice_dict[key], IndiceData)
    if kind == "inverse":
        # the inverse conv outputs the unsorted input's rows
        assert not y.keys_sorted
        np.testing.assert_array_equal(y.indices.numpy(), inds)


def test_unsorted_input_under_auto_matches_jax():
    """``algo="auto"`` on input whose rows are in no key order: the first
    subm stage and the downsample take the native path, the subm stage
    after it (whose input discovery sorted) the DG path, the inverse conv
    the native path on the downsample's rulebook and the last subm conv
    the stage-0 rulebook again; the output and every grad against the JAX
    package's ``"auto"`` (its CPU route)."""
    def layers(mod, **dev):
        return [mod.SubMConv3d(4, 6, 3, indice_key="s0", **dev),
                mod.SparseConv3d(6, 8, 3, stride=2, padding=1,
                                 indice_key="d0", **dev),
                mod.SubMConv3d(8, 8, 3, indice_key="s1", **dev),
                mod.SparseInverseConv3d(8, 6, 3, indice_key="d0", **dev),
                mod.SubMConv3d(6, 5, 3, indice_key="s0", **dev)]

    feats, inds = _input(5, 4)
    y = _run_pair(*_seq_pair(layers(spconv_tpu), layers(st, device="cpu")),
                  feats, inds)
    rec = y.indice_dict
    assert isinstance(rec["s0"], IndiceData)
    assert isinstance(rec["d0"], IndiceData) and not rec["d0"].in_sorted
    assert isinstance(rec["s1"], DGData)
    assert not y.keys_sorted


def test_dg_stage_beside_native_record():
    """A DG subm conv whose ``indice_key`` holds the native path's
    ``IndiceData`` puts its table under ``DGData.cache_key`` and gives the
    native conv's result (the same function: 1e-5 of max|ref|)."""
    feats, inds = _input(6, 4)
    x = st.SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                            SHAPE, 1).sort_by_key()
    g = torch.Generator().manual_seed(0)
    first = st.SubMConv3d(4, 4, 3, indice_key="a", algo="native",
                          device="cpu", generator=g)
    dg = st.SubMConv3d(4, 4, 3, indice_key="a", algo="dg", device="cpu",
                       generator=g)
    native = st.SubMConv3d(4, 4, 3, indice_key="a", algo="native",
                           device="cpu")
    native.load_state_dict(dg.state_dict())
    with torch.no_grad():
        y = first(x)
        got, want = dg(y), native(y)
    assert isinstance(got.indice_dict["a"], IndiceData)
    assert isinstance(got.indice_dict[DGData.cache_key(
        "a", (3, 3, 3), (1, 1, 1))], DGData)
    _close(got.features, want.features.numpy(), FWD_TOL)


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,kw", [
    ("avg", dict(kernel_size=3, stride=2, padding=1)),
    ("avg", dict(kernel_size=3, stride=1, padding=1, subm=True)),
    ("max", dict(kernel_size=3, stride=1, padding=1, subm=True)),
    ("avg", dict(kernel_size=2, stride=2, indice_key="p")),
])
def test_native_pools_match_jax(mode, kw):
    """The native pools the JAX package runs (mean over the present pairs,
    the max with ties split as ``jnp.max`` splits them) on integer-valued
    features: sites exactly, features and grads within 1e-5 / 5e-5 of
    max|ref|."""
    cls = "SparseMaxPool3d" if mode == "max" else "SparseAvgPool3d"
    feats, inds = _input(7, 3, integer=True)
    _run_pair(*_seq_pair([getattr(spconv_tpu, cls)(**kw)],
                         [getattr(st, cls)(**kw)]), feats, inds)


def test_keyed_pool_inverse_gives_every_child_w0():
    """A keyed 2x pool and a ``SparseInverseConv3d`` under its key: the
    pool's rulebook has rank slots and ``pair_bwd`` in row 0 only, so the
    inverse conv computes ``out[child] = x[parent] @ W[0]`` for every
    child, in the JAX package as in the port (ROADMAP.md queue C), not the
    child's own offset ``W[child % 2]``.  Forward and grads against the JAX
    pair."""
    c, k_out = 4, 3
    jl = [spconv_tpu.SparseMaxPool3d(2, 2, indice_key="p"),
          spconv_tpu.SparseInverseConv3d(c, k_out, 2, indice_key="p",
                                         bias=False)]
    tl = [st.SparseMaxPool3d(2, 2, indice_key="p"),
          st.SparseInverseConv3d(c, k_out, 2, indice_key="p", bias=False,
                                 device="cpu")]
    jseq, tseq = _seq_pair(jl, tl)
    feats, inds = _input(8, c)
    y = _run_pair(jseq, tseq, feats, inds)
    rec = y.indice_dict["p"]
    assert rec.rank_slots
    with torch.no_grad():
        pooled = tseq[0](st.SparseConvTensor(
            torch.from_numpy(feats), torch.from_numpy(inds), SHAPE, 1))
    parent = rec.pair_bwd[0].long()
    w0 = tseq[1].weight.detach()[:, 0, 0, 0, :]  # [K, C]
    has = parent >= 0
    want = torch.zeros_like(y.features)
    want[has] = pooled.features[parent[has]] @ w0.t()
    np.testing.assert_allclose(y.features.detach().numpy(), want.numpy(),
                               rtol=0, atol=1e-6)


def test_pool2_past_key_limit_takes_native(monkeypatch):
    """The 2x pool on a grid past the key limit (lowered in both packages)
    takes the native path in both: sites and features against the JAX
    pool."""
    from spconv_tpu.ops import coords as JC
    from spconv_tpu_torch.ops import coords as TC

    monkeypatch.setattr(JC, "_KEY32_LIMIT", 2 ** 10)
    monkeypatch.setattr(TC, "_KEY32_LIMIT", 2 ** 10)
    feats, inds = _input(9, 3, integer=True)
    jx, tx = _tensors(feats, inds)
    ref = spconv_tpu.SparseMaxPool3d(2, 2)(jx)
    y = st.SparseMaxPool3d(2, 2)(tx)
    assert y.indices.dtype == torch.int32
    np.testing.assert_array_equal(y.indices.numpy(), np.asarray(ref.indices))
    _close(y.features, ref.features, 0)


# ---------------------------------------------------------------------------
# the int8 native route
# ---------------------------------------------------------------------------

def _int8_pair(jconv, tconv, seed, scales=(0.05, 0.04)):
    """The JAX ``QuantizedSparseConv`` of ``jconv`` and the port's of
    ``tconv`` (its weights loaded from the JAX conv)."""
    load_jax_state_dict(tconv, state_dict(jconv))
    rng = np.random.RandomState(seed)
    w_scale = (np.abs(rng.randn(jconv.out_channels)) / 100 + 1e-3).astype(
        np.float32)
    return (jq.QuantizedSparseConv(jconv, w_scale, *scales),
            tq.QuantizedSparseConv(tconv, w_scale, *scales))


def _int8_formula(q_in, w_i8, pair_fwd, scale_q, bias_q):
    """numpy: ``clip(rint(f32(acc) * scale_q + bias_q))`` of the int32 sums
    over ``pair_fwd``, each float step rounded on its own."""
    k_out, c = w_i8.shape[0], w_i8.shape[-1]
    wkv = w_i8.reshape(k_out, -1, c).transpose(1, 2, 0).astype(np.int64)
    acc = np.zeros((pair_fwd.shape[1], k_out), np.int64)
    for k in range(pair_fwd.shape[0]):
        hit = pair_fwd[k] >= 0
        acc[hit] += q_in[pair_fwd[k, hit]].astype(np.int64) @ wkv[k]
    y = acc.astype(np.float32) * scale_q
    if bias_q is not None:
        y = (y + bias_q).astype(np.float32)
    return np.clip(np.rint(y), -127, 127).astype(np.int8)


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_int8_native_route(kind):
    """An int8 conv on input whose rows are in no key order: bit-equal to
    the kernel route's formula on the rulebook, and within one step on at
    most 1 % of entries of the JAX package's native route."""
    c, k_out = 8, 16
    if kind == "subm":
        jc = spconv_tpu.SubMConv3d(c, k_out, 3, indice_key="s")
        tc = st.SubMConv3d(c, k_out, 3, indice_key="s", device="cpu")
    else:
        jc = spconv_tpu.SparseConv3d(c, k_out, 3, stride=2, padding=1,
                                     indice_key="d")
        tc = st.SparseConv3d(c, k_out, 3, stride=2, padding=1,
                             indice_key="d", device="cpu")
    jm, tm = _int8_pair(jc, tc, 10)
    rng = np.random.RandomState(11)
    _, inds = _input(12, c)
    q_in = rng.randint(-127, 128, size=(NBUF, c)).astype(np.int8)
    q_in[inds[:, 0] < 0] = 0
    jx, tx = _tensors(q_in, inds)
    ref = jm(jx)
    with torch.no_grad():
        y = tm(tx)
    got = y.features.numpy()
    assert y.features.dtype == torch.int8
    assert y.keys_sorted == (kind == "strided")
    np.testing.assert_array_equal(y.indices.numpy(), np.asarray(ref.indices))
    rec = y.indice_dict["s" if kind == "subm" else "d"]
    assert isinstance(rec, IndiceData)
    want = _int8_formula(q_in, tm.weight_i8.numpy(), rec.pair_fwd.numpy(),
                         tm.scale_q.numpy(),
                         None if tm.bias_q is None else tm.bias_q.numpy())
    want[y.indices.numpy()[:, 0] < 0] = 0
    np.testing.assert_array_equal(got, want)
    diff = np.abs(got.astype(np.int32) - np.asarray(ref.features, np.int32))
    print(f"int8 {kind}: {int((diff > 0).sum())} of {diff.size} entries "
          f"differ from the JAX native route, at most {int(diff.max())}")
    assert diff.max() <= INT8_STEPS
    assert (diff > 0).mean() <= INT8_SHARE


# ---------------------------------------------------------------------------
# the core leftovers
# ---------------------------------------------------------------------------

def test_from_dense_select_by_index_scatter_nd_match_jax():
    """``from_dense`` (rows in flat order, ``keys_sorted``, with and
    without ``pad_to``), ``select_by_index`` (the rows, the count, the
    cleared cache) and ``scatter_nd`` (a negative index counts from the
    end, an index past the end is dropped) against the JAX package."""
    rng = np.random.RandomState(13)
    dense = rng.randn(2, 4, 5, 3).astype(np.float32)
    dense[rng.rand(2, 4, 5) < 0.7] = 0
    for pad_to in (None, 24):
        ref = spconv_tpu.SparseConvTensor.from_dense(jnp.asarray(dense),
                                                     pad_to=pad_to)
        got = st.SparseConvTensor.from_dense(torch.from_numpy(dense),
                                             pad_to=pad_to)
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(ref.indices))
        np.testing.assert_array_equal(got.features.numpy(),
                                      np.asarray(ref.features))
        assert got.keys_sorted and int(got.num_voxels) == int(
            ref.num_voxels)
    sel = np.array([5, 0, 3, 23, 7], np.int64)
    got.indice_dict["k"] = 1
    s = got.select_by_index(torch.from_numpy(sel))
    r = ref.select_by_index(jnp.asarray(sel))
    np.testing.assert_array_equal(s.indices.numpy(), np.asarray(r.indices))
    np.testing.assert_array_equal(s.features.numpy(), np.asarray(r.features))
    assert int(s.num_voxels) == int(r.num_voxels) and not s.indice_dict
    idx = np.array([[0, 1], [-1, 2], [5, 0], [1, -3], [-4, 0]], np.int32)
    upd = np.arange(10, dtype=np.float32).reshape(5, 2)
    np.testing.assert_array_equal(
        st.scatter_nd(torch.from_numpy(idx), torch.from_numpy(upd),
                      (2, 3, 2)).numpy(),
        np.asarray(jax_scatter_nd(jnp.asarray(idx), jnp.asarray(upd),
                                  (2, 3, 2))))


# ---------------------------------------------------------------------------
# a grid past 2**31 sites
# ---------------------------------------------------------------------------

def test_grid_past_int32_keys_matches_jax():
    """A subm and a strided conv on a ``[160, 2048, 2048]`` grid of batch 4
    (2.7e9 sites: int64 keys here, two-word keys in the JAX package), both
    on the native path under ``"auto"``: forward and grads against the
    JAX pair."""
    shape, batch = (160, 2048, 2048), 4
    rng = np.random.RandomState(14)
    centre = np.array([80, 1024, 1024])
    inds = np.unique(np.concatenate(
        [np.repeat(np.arange(batch), 30)[:, None],
         centre + rng.randint(-3, 4, size=(batch * 30, 3))], axis=1),
        axis=0).astype(np.int32)
    ib = np.full((128, 4), -1, np.int32)
    ib[:len(inds)] = inds
    ib = ib[rng.permutation(128)]
    feats = (rng.randn(128, 3) * (ib[:, :1] >= 0)).astype(np.float32)

    def layers(mod, **dev):
        return [mod.SubMConv3d(3, 4, 3, indice_key="s", **dev),
                mod.SparseConv3d(4, 5, 3, stride=2, padding=1,
                                 indice_key="d", **dev)]

    y = _run_pair(*_seq_pair(layers(spconv_tpu), layers(st, device="cpu")),
                  feats, ib, shape, batch)
    assert isinstance(y.indice_dict["d"], IndiceData)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_native_benchnet_shape_matches_jax():
    """Two subm stages with a 2x max pool between them (BenchNet's shape at
    narrow widths, ``bias=False``, keys ``c0`` and ``c1``) on
    ``algo="native"``: output and every grad against the JAX net."""
    def layers(mod, **dev):
        convs = [(3, 8, "c0"), (8, 8, "c0"), (8, 12, "c1"), (12, 12, "c1")]
        m = [mod.SubMConv3d(ci, co, 3, bias=False, indice_key=key,
                            algo="native", **dev) for ci, co, key in convs]
        return m[:2] + [mod.SparseMaxPool3d(2, 2)] + m[2:]

    feats, inds = _input(15, 3, shape=(16, 16, 16), n=300, nbuf=384)
    _run_pair(*_seq_pair(layers(spconv_tpu), layers(st, device="cpu")),
              feats, inds, shape=(16, 16, 16))


def test_unet_on_unsorted_input_matches_jax():
    """The small ``SparseUNet`` on input whose rows are in no key order,
    on ``"auto"`` in both packages (native stage 0 and downsample, DG after
    it in the port): the output has the input's rows, and its features and
    every parameter's grad match the JAX net's."""
    from spconv_tpu.models import SparseUNet as JaxUNet

    channels = (4, 8)
    jnet = JaxUNet(in_channels=3, channels=channels, num_classes=5)
    tnet = load_jax_state_dict(st.SparseUNet(3, channels, 5, device="cpu"),
                               state_dict(jnet))
    feats, inds = _input(16, 3, shape=(12, 12, 12), n=150, nbuf=192)
    jx, tx = _tensors(feats, inds, (12, 12, 12))
    tx = tx.replace_feature(tx.features.clone().requires_grad_())
    y = tnet(tx)
    (y.features ** 2).sum().backward()

    def loss(tree):
        m, f = tree
        out = m(jx.replace_feature(f))
        return jnp.sum(out.features ** 2), out

    (_, ref), (gm, gf) = spconv_tpu.filter_value_and_grad(
        loss, has_aux=True)((jnet, jnp.asarray(feats)))
    np.testing.assert_array_equal(y.indices.numpy(), inds)
    np.testing.assert_array_equal(np.asarray(ref.indices), inds)
    _close(y.features, ref.features, 1e-4)
    _close(tx.features.grad, gf, GRAD_TOL)
    g_ref = state_dict(gm)
    for name, p in tnet.named_parameters():
        _close(p.grad, g_ref[name], GRAD_TOL)
