"""The port's conv tuner against the JAX package's on the CPU (the
counterparts of ``tests/test_ndim_and_tuner.py``'s tuner tests): the B2
tile cache round trip (the JAX gather chunk's counterpart), ``select_algo``
with and without a cached winner and the port's heuristic, ``ConvAlgo``
and ``SPCONV_TPU_ALGO``, and tune-on-first-call through ``algo="auto"``
with an injected timer and with real timing.  Every tuner here has its own
cache directory under ``tmp_path``; the default one is never written."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.checkpoint import state_dict
from spconv_tpu.ops import gather_gemm as JG
from spconv_tpu.tuner import ConvTuner as JaxTuner

import spconv_tpu_torch as st
from spconv_tpu_torch import tuner as tuner_mod
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.core import IndiceData
from spconv_tpu_torch.modules.conv import DGData
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.ops import gather_gemm as TG

from utils import generate_sparse_data, pad_sparse

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (9, 10, 11)
FWD_TOL = 1e-6  # f32, of max|ref|: the same sums in another order
BF16_TOL = 1.6e-2  # bf16, of max|ref|: the repo's bf16 kernel gate


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel may launch."""
    TD.reset_launch_counts()
    yield
    assert not any(TD.launch_counts.values())


def _sorted_input(seed, c=6, n=150, nbuf=256):
    """Seeded features and coordinates, rows key-sorted with the invalid
    tail, as numpy arrays."""
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(SHAPE, n, c, batch_size=1, rng=rng)
    fp, ip = pad_sparse(feats, inds, nbuf)
    key = ip[:, 0].astype(np.int64)
    for a, s in enumerate(SHAPE):
        key = key * s + ip[:, a + 1]
    order = np.argsort(np.where(ip[:, 0] >= 0, key, 2 ** 62), kind="stable")
    return fp[order], ip[order]


def test_tuner_tile_heuristic_and_cache(tmp_path):
    """``get_tuned_params("gather_mm", ...)`` is B2's own tile until a
    tuning caches a winner (``tune_conv_tile`` on live data); a second
    tuner on the same directory reads it back; ``gather_mm`` on the winner
    equals the JAX ``gather_mm`` on the same inputs."""
    t = st.ConvTuner(cache_dir=str(tmp_path))
    p = t.get_tuned_params("gather_mm", 4096, 64, 64, 27, "bfloat16")
    assert p == {"tile": TD.b2_variant(4096, 64, 64).tile,
                 "source": "heuristic"}
    rng = np.random.RandomState(42)
    bf = torch.bfloat16
    feats = torch.from_numpy(rng.randn(257, 8).astype(np.float32)).to(bf)
    pair = rng.randint(-1, 256, size=(27, 256)).astype(np.int32)
    wkv = torch.from_numpy(rng.randn(27, 8, 8).astype(np.float32)).to(bf)
    won = t.tune_conv_tile(feats, wkv, torch.from_numpy(pair), None,
                           tiles=(0, 2))
    assert won["source"] == "tuned" and won["tile"] in (0, 2)
    assert np.isfinite(won["ms"]) and won["ms"] >= 0
    t2 = st.ConvTuner(cache_dir=str(tmp_path))
    p2 = t2.get_tuned_params("gather_mm", 256, 8, 8, 27, "bfloat16")
    assert p2 == won
    cache = json.loads((tmp_path / "conv_tune_cache.json").read_text())
    assert list(cache) == ["gather_mm|n1024|c8|k8|kv27|bfloat16"]
    got = TG.gather_mm(feats, wkv, torch.from_numpy(pair), None,
                       tile=won["tile"]).float().numpy()
    ref = np.asarray(JG.gather_mm(
        jnp.asarray(feats.float().numpy(), jnp.bfloat16),
        jnp.asarray(wkv.float().numpy(), jnp.bfloat16), jnp.asarray(pair),
        None)).astype(np.float32)
    # one bf16 rounding of f32 sums in another order
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=BF16_TOL * np.abs(ref).max())


def test_tile_argument_checked():
    """``dg_fwd``'s ``tile`` is one of B2's bf16 tiles, on bf16 features
    only."""
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    w = torch.zeros((27, 8, 8), dtype=torch.bfloat16)
    pos = torch.full((27, 4), -1, dtype=torch.int32)
    assert not TD.dg_fwd(x, w, pos, tile=4).any()
    with pytest.raises(ValueError, match="tile"):
        TD.dg_fwd(x, w, pos, tile=len(TD.B2_TILES))
    with pytest.raises(ValueError, match="tile"):
        TD.dg_fwd(x.float(), w.float(), pos, tile=0)


@pytest.mark.parametrize("training", [False, True])
def test_select_algo_and_cache(tmp_path, training):
    """The port's heuristic is ``"dg"`` where the DG route serves and
    ``"native"`` elsewhere, on the CPU as on the card (the JAX tuner's CPU
    heuristic is ``"native"``); a cached winner overrides it, separately
    for the training key; a fresh tuner reads it from disk; a winner the
    layer cannot run is ignored."""
    t = st.ConvTuner(cache_dir=str(tmp_path))
    kw = dict(subm=True, sk_supported=True, dg_supported=True, n=4096,
              c=64, k=64, kv=27, dtype="bfloat16", training=training)
    assert t.select_algo(**kw) == "dg"
    assert t.select_algo(**dict(kw, sk_supported=False,
                                dg_supported=False)) == "native"
    assert JaxTuner(cache_dir=str(tmp_path / "jax")).select_algo(
        **kw) == "native"
    sig = dict(n=4096, c=64, k=64, kv=27, dtype="bfloat16")
    assert not t.has_algo(**sig, training=training)
    t.cache_algo(**sig, algo="sk", ms=1.0, training=training)
    assert t.has_algo(**sig, training=training)
    assert not t.has_algo(**sig, training=not training)
    assert t.select_algo(**kw) == "sk"
    assert t.select_algo(**dict(kw, training=not training)) == "dg"
    t2 = st.ConvTuner(cache_dir=str(tmp_path))
    assert t2.select_algo(**kw) == "sk"
    assert t2.select_algo(**dict(kw, sk_supported=False,
                                 dg_supported=False)) == "native"
    t2.cache_algo(**sig, algo="dg", training=training)
    assert t2.select_algo(**dict(kw, dg_supported=False,
                                 sk_supported=False)) == "native"
    # the key spells the dtype as JAX does
    assert t2.has_algo(**dict(sig, dtype=torch.bfloat16), training=training)
    # resolve(), the conv's lookup, takes the call's signature (training:
    # grad mode on and the weight's gradient wanted) and remembers it until
    # a new winner is cached
    conv = st.SubMConv3d(64, 64, 3, dtype=torch.bfloat16, device="cpu")
    x = st.SparseConvTensor(torch.zeros((4096, 64), dtype=torch.bfloat16),
                            torch.full((4096, 4), -1, dtype=torch.int32),
                            (8, 8, 8), 1)
    with torch.set_grad_enabled(training):
        assert t2.resolve(conv, x, True) == "dg"
        assert t2.resolve(conv, x, False) == "native"
        t2.cache_algo(**sig, algo="native", training=training)
        assert t2.resolve(conv, x, True) == "native"
        conv.weight.requires_grad_(False)  # a forward-only call's key
        assert t2.resolve(conv, x, True) == (
            "dg" if training else "native")
    # nothing cached, no tuning: the heuristic, no signature built
    empty = st.ConvTuner(cache_dir=str(tmp_path / "empty"))
    assert empty.resolve(None, None, True) == "dg"
    assert empty.resolve(None, None, False) == "native"


def test_conv_algo_enum():
    """``ConvAlgo`` is the reference's enum with the JAX package's values;
    the conv modules take it for ``algo``; the default is ``"auto"``."""
    assert [a.value for a in st.ConvAlgo] == [
        a.value for a in spconv_tpu.ConvAlgo] == ["native", "sk"]
    assert st.ConvAlgo.MaskSplitImplicitGemm is st.ConvAlgo.MaskImplicitGemm
    for algo, want in ((st.ConvAlgo.Native, "native"),
                       (st.ConvAlgo.MaskSplitImplicitGemm, "sk"),
                       (None, "auto")):
        conv = st.SubMConv3d(4, 8, 3, algo=algo, device="cpu")
        assert conv.algo == want == spconv_tpu.SubMConv3d(
            4, 8, 3, algo=algo and spconv_tpu.ConvAlgo(algo.value)).algo


def test_algo_and_cache_env(tmp_path):
    """``SPCONV_TPU_ALGO`` sets the layer default and
    ``SPCONV_TPU_TUNE_CACHE`` the tuner's directory, read when the port is
    imported (a fresh interpreter); the default directory is the port's
    own."""
    code = ("import spconv_tpu_torch as st; "
            "print(st.SubMConv3d(4, 8, 3, device='cpu').algo); "
            "print(st.CONV_TUNER.cache_dir)")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SPCONV_TPU_")}
    env["PYTHONPATH"] = str(ROOT)

    def run(**extra):
        out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                             env=dict(env, **extra), capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return out.stdout.split()

    algo, cache = run(HOME=str(tmp_path))
    assert algo == "auto"
    assert cache == str(tmp_path / ".cache" / "spconv_tpu_torch")
    algo, cache = run(SPCONV_TPU_ALGO="native",
                      SPCONV_TPU_TUNE_CACHE=str(tmp_path / "tc"))
    assert (algo, cache) == ("native", str(tmp_path / "tc"))


def _conv_pair(key_name):
    """A JAX ``SubMConv3d(6, 8, 3)`` and the port's with its weights."""
    jm = spconv_tpu.SubMConv3d(6, 8, 3, indice_key=key_name, algo="auto",
                               key=jax.random.PRNGKey(0))
    tm = load_jax_state_dict(
        st.SubMConv3d(6, 8, 3, indice_key=key_name, device="cpu"),
        state_dict(jm))
    return jm, tm


@pytest.mark.parametrize("winner", ["native", "dg"])
@pytest.mark.parametrize("key_name", [None, "t0"])
def test_tune_on_first_call(tmp_path, monkeypatch, winner, key_name):
    """With tuning on, the first ``"auto"`` call times ``native``, ``sk``
    and ``dg`` (an injected timer here), caches the winner and runs it;
    the live tensor's ``indice_dict`` is unchanged and the output holds
    only the winner's record; the output matches the JAX layer's within
    1e-6 of max; a second call reads the cache and times nothing."""
    t = st.ConvTuner(cache_dir=str(tmp_path))
    t.force_tune = True
    monkeypatch.setattr(tuner_mod, "CONV_TUNER", t)
    fp, ip = _sorted_input(0)
    jm, tm = _conv_pair(key_name)
    x = st.SparseConvTensor(torch.from_numpy(fp), torch.from_numpy(ip),
                            SHAPE, 1, keys_sorted=True)
    timed = []
    real = t.tune_conv_algo

    def fake_tune(module, inp, candidates, **sig):
        timed.extend(candidates)
        ms = {a: 9.0 for a in candidates}
        ms[winner] = 1.0
        return real(module, inp, candidates, timer=ms.get, **sig)

    t.tune_conv_algo = fake_tune
    with torch.no_grad():
        out = tm(x)
    assert timed == ["native", "sk", "dg"]
    assert x.indice_dict == {}
    if key_name is None:
        assert out.indice_dict == {}
    else:
        assert list(out.indice_dict) == [key_name]
        assert isinstance(out.indice_dict[key_name],
                          IndiceData if winner == "native" else DGData)
    sig = dict(n=256, c=6, k=8, kv=27, dtype="float32")
    assert t.has_algo(**sig) and not t.has_algo(**sig, training=True)
    assert t.select_algo(subm=True, sk_supported=True, dg_supported=True,
                         **sig) == winner
    rec = json.loads((tmp_path / "conv_tune_cache.json").read_text())
    assert rec["algo|n1024|c6|k8|kv27|float32"]["candidates"] == {
        a: (1.0 if a == winner else 9.0) for a in ("native", "sk", "dg")}
    ref = np.asarray(jm(spconv_tpu.SparseConvTensor(
        jnp.asarray(fp), jnp.asarray(ip), SHAPE, 1,
        keys_sorted=True)).features)
    np.testing.assert_allclose(out.features.numpy(), ref, rtol=0,
                               atol=FWD_TOL * np.abs(ref).max())
    t.tune_conv_algo = None  # a second call must not tune
    with torch.no_grad():
        again = tm(x)
    assert torch.equal(again.features, out.features)


def test_tune_unsorted_input_times_native_only(tmp_path, monkeypatch):
    """Where the DG route does not serve (rows in no key order), the only
    candidate is ``native``."""
    t = st.ConvTuner(cache_dir=str(tmp_path))
    t.force_tune = True
    monkeypatch.setattr(tuner_mod, "CONV_TUNER", t)
    fp, ip = _sorted_input(1)
    perm = np.random.RandomState(1).permutation(len(ip))
    x = st.SparseConvTensor(torch.from_numpy(fp[perm]),
                            torch.from_numpy(ip[perm]), SHAPE, 1)
    _, tm = _conv_pair("u0")
    seen = []
    t.tune_conv_algo = lambda m, i, cands, **sig: seen.extend(cands) or \
        "native"
    with torch.no_grad():
        tm(x)
    assert seen == ["native"]


@pytest.mark.parametrize("training", [False, True])
def test_tune_measures_candidates(tmp_path, monkeypatch, training):
    """Real timing (``tools.benchmark_model``, the host clock on the CPU):
    every candidate gets a finite ms under the signature's key
    (``algo_train`` for a call with the weight's gradient wanted), and
    the tuned layer's output and gradients equal an untuned layer's on
    the same algorithm."""
    t = st.ConvTuner(cache_dir=str(tmp_path))
    t.force_tune = True
    monkeypatch.setattr(tuner_mod, "CONV_TUNER", t)
    fp, ip = _sorted_input(2)
    _, tm = _conv_pair("m0")
    tm.weight.requires_grad_(training)
    f = torch.from_numpy(fp).requires_grad_(training)
    x = st.SparseConvTensor(f, torch.from_numpy(ip), SHAPE, 1,
                            keys_sorted=True)
    out = tm(x)
    rec = json.loads((tmp_path / "conv_tune_cache.json").read_text())
    key = f"{'algo_train' if training else 'algo'}|n1024|c6|k8|kv27|float32"
    assert list(rec) == [key]
    cands = rec[key]["candidates"]
    assert set(cands) == {"native", "sk", "dg"}
    assert all(np.isfinite(v) and v >= 0 for v in cands.values())
    assert rec[key]["algo"] == min(cands, key=cands.get)
    plain = load_jax_state_dict(
        st.SubMConv3d(6, 8, 3, indice_key="m0", algo=rec[key]["algo"],
                      device="cpu"),
        {k: v.detach().numpy() for k, v in tm.state_dict().items()})
    f2 = torch.from_numpy(fp).requires_grad_(training)
    ref = plain(st.SparseConvTensor(f2, torch.from_numpy(ip), SHAPE, 1,
                                    keys_sorted=True))
    assert torch.equal(out.features, ref.features)
    if training:
        (out.features ** 2).sum().backward()
        (ref.features ** 2).sum().backward()
        assert torch.equal(f.grad, f2.grad)
        assert torch.equal(tm.weight.grad, plain.weight.grad)
