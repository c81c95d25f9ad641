"""The port's voxelizer against the JAX package on the CPU:
``point_to_voxel`` / ``PointToVoxel`` (all five outputs bit for bit, at
ndim 2-4, one and five points a voxel, with and without empty means, a
voxel cap below and above the voxel count, non-finite and out-of-range
points, points near the faces of 0.1 m voxels, and a grid past the int32
key limit), the native host voxelizer, ``gather_features_by_pc_voxel_id``,
the CenterPoint point-cloud input, and the slice as a whole: a voxelized
cloud through a narrow encoder against the JAX voxelizer and encoder."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.checkpoint import state_dict
from spconv_tpu.csrc.host_api import point_to_voxel_host
from spconv_tpu.models import SparseEncoder as JaxEncoder
from spconv_tpu.ops import coords as JC
from spconv_tpu.ops.point2voxel import \
    gather_features_by_pc_voxel_id as jax_gather
from spconv_tpu.ops.point2voxel import point_to_voxel as jax_p2v
from spconv_tpu.utils import PointToVoxel as JaxPointToVoxel

import spconv_tpu_torch as st
from spconv_tpu_torch.benchmark import centerpoint as CP
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.models import SparseEncoder
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops.point2voxel import (gather_features_by_pc_voxel_id,
                                              point_to_voxel)
from spconv_tpu_torch.utils import (Point2VoxelCPU3d, Point2VoxelGPU2d,
                                    PointToVoxel)


def _cloud(seed, ndim, n=600, c=None, lo=-2.0, hi=4.0, bad=True):
    """``n`` points of ``ndim + 1`` columns in [lo, hi) (the voxelizers
    below cover [-1, 3)), the first rows NaN, +inf and -inf on some axis
    when ``bad``."""
    rng = np.random.RandomState(seed)
    pc = rng.uniform(lo, hi, size=(n, c or ndim + 1)).astype(np.float32)
    if bad:
        pc[0:4, 0] = np.nan
        pc[4:7, ndim - 1] = np.inf
        pc[7:9, 0] = -np.inf
        pc[9, :ndim] = np.nan
    return pc


def _assert_outputs_equal(got, want):
    names = ("voxels", "coords", "num_per_voxel", "pc_voxel_id",
             "num_voxels")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


CASES = [
    # (ndim, max points a voxel, empty_mean, max voxels)
    (3, 5, False, 600),
    (3, 5, True, 600),
    (3, 1, False, 600),
    (3, 1, True, 40),   # the cap below the voxel count
    (3, 5, True, 40),
    (2, 5, True, 100),
    (2, 1, False, 7),
    (4, 5, False, 500),
    (4, 3, True, 500),
]


@pytest.mark.parametrize("ndim,maxpts,empty_mean,maxvox", CASES)
def test_point_to_voxel_matches_jax(ndim, maxpts, empty_mean, maxvox):
    """All five outputs bit-equal to the JAX function's, padding included:
    points past the cap, NaN, +-inf and out-of-range points dropped
    alike."""
    pc = _cloud(ndim * 10 + maxpts, ndim)
    kw = dict(vsize_xyz=(0.5,) * ndim, coors_range_xyz=(-1.0,) * ndim
              + (3.0,) * ndim, max_num_voxels=maxvox,
              max_num_points_per_voxel=maxpts, empty_mean=empty_mean)
    got = point_to_voxel(torch.from_numpy(pc), **kw)
    want = jax_p2v(jnp.asarray(pc), **kw)
    _assert_outputs_equal(got, want)
    nv = int(got[4])
    assert 0 < nv <= maxvox and (got[1][nv:] == -1).all()
    assert (got[3][:10] == -1).all()  # the non-finite points


@pytest.mark.parametrize("empty_mean", [False, True])
def test_empty_cloud_matches_jax(empty_mean):
    """No points at all, and no point in range: empty buffers, as JAX's."""
    kw = dict(vsize_xyz=(0.5,) * 3, coors_range_xyz=(-1.0,) * 3 + (3.0,) * 3,
              max_num_voxels=16, max_num_points_per_voxel=2,
              empty_mean=empty_mean)
    for pc in (np.zeros((0, 4), np.float32),
               np.full((5, 4), 7.0, np.float32)):
        got = point_to_voxel(torch.from_numpy(pc), **kw)
        _assert_outputs_equal(got, jax_p2v(jnp.asarray(pc), **kw))
        assert int(got[4]) == 0


def _near_faces(seed=3, n=800):
    """Points of ``[-2, 2)^3`` within 1e-6 m of a face of the 0.1 m grid,
    the first 20 on the range's lower corner and the next 20 on its
    (exclusive) upper one."""
    rng = np.random.RandomState(seed)
    faces = rng.randint(-20, 20, size=(n, 3)) * 0.1
    pc = np.concatenate([faces + rng.uniform(-1e-6, 1e-6, faces.shape),
                         rng.randn(n, 1)], 1).astype(np.float32)
    pc[:20, :3] = np.float32(-2.0)
    pc[20:40, :3] = np.float32(2.0)
    return pc


FACES = dict(vsize_xyz=(0.1,) * 3, coors_range_xyz=(-2.0,) * 3 + (2.0,) * 3,
             max_num_voxels=2000, max_num_points_per_voxel=3,
             empty_mean=False)


def _quantized(pc, reciprocal):
    """The voxel of each point in numpy f32: ``(x - lower) / vsize``, or
    times ``f32(1 / vsize)`` with ``reciprocal``."""
    d = pc[:, :3] - np.float32(-2.0)
    vs = np.float32(0.1)
    return np.floor(d * (np.float32(1) / vs) if reciprocal else d / vs)


def test_points_near_voxel_faces_quantize_by_division():
    """The port quantizes by a true f32 division, ``floor((xyz - lower) /
    vsize)``, as the reference does; XLA compiles the JAX package's
    division by the constant vsize into a multiply by ``f32(1 / vsize)``
    (ROADMAP.md queue C), and for a point within an ulp of a face the two
    can differ by one voxel on an axis.  Pinned here: the port's voxels
    are the division's, JAX's the multiply's, and the two disagree on some
    of these points, exactly those where the two quantizations differ."""
    pc = _near_faces()
    got = point_to_voxel(torch.from_numpy(pc), **FACES)
    want = jax_p2v(jnp.asarray(pc), **FACES)
    div, mul = _quantized(pc, False), _quantized(pc, True)
    for (coords, vid), q in (((got[1].numpy(), got[3].numpy()), div),
                             ((np.asarray(want[1]), np.asarray(want[3])),
                              mul)):
        kept = vid >= 0
        np.testing.assert_array_equal(coords[vid[kept]],
                                      q[kept][:, ::-1].astype(np.int32))
    differs = (div != mul).any(1)
    assert differs.sum() > 0
    point_voxel = got[1].numpy()[got[3].numpy()]
    jax_voxel = np.asarray(want[1])[np.asarray(want[3])]
    moved = (point_voxel != jax_voxel).any(1)
    np.testing.assert_array_equal(moved, differs)
    both = (got[3].numpy() >= 0) & (np.asarray(want[3]) >= 0)
    assert (np.abs(point_voxel - jax_voxel).max(1)[moved & both] == 1).all()


def test_points_near_voxel_faces_match_jax():
    """The same near-face cloud without the points whose quantizations
    differ: all five outputs bit-equal to the JAX function's, the points
    on the range's lower corner kept and those on its upper one
    dropped."""
    pc = _near_faces()
    pc = pc[~(_quantized(pc, False) != _quantized(pc, True)).any(1)]
    got = point_to_voxel(torch.from_numpy(pc), **FACES)
    _assert_outputs_equal(got, jax_p2v(jnp.asarray(pc), **FACES))
    assert (got[3][:20] >= 0).all() and (got[3][20:40] == -1).all()


def test_int64_key_grid_matches_jax(monkeypatch):
    """A grid past ``_KEY32_LIMIT`` (lowered in both packages): the port's
    int64 keys sort as the JAX two-word keys, so the outputs are equal."""
    monkeypatch.setattr(JC, "_KEY32_LIMIT", 2 ** 10)
    monkeypatch.setattr(JC, "_LO_LIMIT", 2 ** 5)
    monkeypatch.setattr(TC, "_KEY32_LIMIT", 2 ** 10)
    monkeypatch.setattr(TC, "_LO_LIMIT", 2 ** 5)
    grid = (16, 16, 16)
    assert TC.use_int64_keys(grid, 1) and JC.use_pair_keys(grid, 1)
    # a point count of its own, so that the jitted JAX function traces
    # anew under the lowered limit
    pc = _cloud(5, 3, n=613)
    kw = dict(vsize_xyz=(0.25,) * 3, coors_range_xyz=(-1.0,) * 3
              + (3.0,) * 3, max_num_voxels=500,
              max_num_points_per_voxel=2, empty_mean=True)
    got = point_to_voxel(torch.from_numpy(pc), **kw)
    _assert_outputs_equal(got, jax_p2v(jnp.asarray(pc), **kw))


def test_point_to_voxel_matches_host_library():
    """The native host voxelizer orders voxels by first occurrence, the
    port by key: aligned by coordinate, the counts and each voxel's points
    agree."""
    pc = _cloud(7, 3, n=400, c=4, bad=False)
    v_h, c_h, n_h, id_h, nv_h = point_to_voxel_host(
        pc, [0.5] * 3, [-1, -1, -1, 3, 3, 3], 600, 4)
    gen = PointToVoxel([0.5] * 3, [-1, -1, -1, 3, 3, 3], 4, 600, 4,
                       device="cpu")
    v, c, n, vid, nv = gen.generate_voxel_with_id(pc)
    assert nv_h == int(nv)
    where = {tuple(c_h[i]): i for i in range(nv_h)}
    for j in range(int(nv)):
        i = where[tuple(c[j].tolist())]
        assert n_h[i] == int(n[j])
        np.testing.assert_array_equal(v_h[i, :n_h[i]], v[j, :n_h[i]].numpy())
    # each point's voxel, through the coordinate map
    remap = np.array([where[tuple(c[j].tolist())] for j in range(int(nv))])
    got = np.where(vid.numpy() >= 0, remap[np.maximum(vid.numpy(), 0)], -1)
    np.testing.assert_array_equal(got, id_h)


def test_point_to_voxel_class():
    """``PointToVoxel`` against the JAX class: ``grid_size`` (ZYX), the
    three outputs of a call, a numpy input moved to the device, the
    aliases; with no device given it runs on the CUDA card (here: raises,
    there is none)."""
    args = ([0.2, 0.25, 0.5], [-1, -1, -1, 3, 2, 3], 4, 300, 3)
    gen = PointToVoxel(*args, device="cpu")
    jgen = JaxPointToVoxel(*args)
    assert gen.grid_size == jgen.grid_size == (8, 12, 20)
    assert Point2VoxelCPU3d is Point2VoxelGPU2d is PointToVoxel
    pc = _cloud(11, 3)
    got = gen(pc, empty_mean=True)
    assert len(got) == 3 and got[0].device.type == "cpu"
    want = jgen(pc, empty_mean=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PointToVoxel(*args)


def test_gather_features_by_pc_voxel_id_matches_jax():
    rng = np.random.RandomState(2)
    feats = rng.randn(50, 3, 2).astype(np.float32)
    vid = rng.randint(-1, 50, size=300).astype(np.int32)
    for invalid in (0, -7.5):
        got = gather_features_by_pc_voxel_id(torch.from_numpy(feats),
                                             torch.from_numpy(vid), invalid)
        want = np.asarray(jax_gather(jnp.asarray(feats), jnp.asarray(vid),
                                     invalid))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[vid < 0] == invalid).all()


SMALL = dict(shape=(16, 64, 64), n_target=1500)


@pytest.fixture(scope="module")
def cloud():
    return CP.synthetic_centerpoint_points(0, **SMALL)


def test_centerpoint_points_fall_in_the_scan_voxels(cloud):
    """The cloud voxelizes to exactly the stand-in scan's sites, the
    points outside the range are about 5 % and get voxel id -1, and the
    JAX loader's path (JAX ``PointToVoxel`` with its parameters, the first
    point's xyz, intensity 1, timestamp 0, rows cut and padded to 1024)
    builds the same tensor."""
    x, nv = CP.voxelized_centerpoint_input(points=cloud, device="cpu")
    ref, n_ref = CP.synthetic_centerpoint_input(0, device="cpu", **SMALL)
    assert nv == n_ref == 1500 and x.keys_sorted
    assert x.spatial_shape == CP.CP_SHAPE
    np.testing.assert_array_equal(x.indices.numpy(), ref.indices.numpy())
    lo, hi = np.array(CP.CP_RANGE[:3]), np.array(CP.CP_RANGE[3:])
    out = ~((cloud >= lo) & (cloud < hi)).all(1)
    assert 0.04 < out.mean() < 0.06

    jgen = JaxPointToVoxel(CP.CP_VSIZE, CP.CP_RANGE, 3, CP.CP_MAX_VOXELS, 1)
    voxels, coords, _, vid, jnv = jgen.generate_voxel_with_id(cloud)
    np.testing.assert_array_equal(np.asarray(vid) < 0, out)
    jnv = int(jnv)
    fp = np.zeros((2048, 5), np.float32)
    ip = np.full((2048, 4), -1, np.int32)
    fp[:jnv, :3] = np.asarray(voxels).reshape(-1, 3)[:jnv]
    fp[:jnv, 3] = 1.0
    ip[:jnv, 0] = 0
    ip[:jnv, 1:] = np.asarray(coords)[:jnv]
    np.testing.assert_array_equal(x.features.numpy(), fp)
    np.testing.assert_array_equal(x.indices.numpy(), ip)


def test_points_to_encoder_slice_matches_jax(cloud):
    """The slice: a scaled-down cloud (1,500 voxels on a 1.6 x 6.4 x 6.4 m
    range at 0.1 m) voxelized by each package, through a narrow two-stage
    encoder carrying the JAX weights (the port's plain path; the JAX CPU
    route), and the first layer's output mapped back to the points:
    voxelizer outputs bit-equal, coordinates equal at every stage,
    features within 1e-4*max|ref| (f32 sums in another order)."""
    rng = (-51.2, -51.2, -5.0, -44.8, -44.8, -3.4)
    gen = PointToVoxel(CP.CP_VSIZE, rng, 3, 2048, 1, device="cpu")
    jgen = JaxPointToVoxel(CP.CP_VSIZE, rng, 3, 2048, 1)
    got = gen.generate_voxel_with_id(cloud)
    _assert_outputs_equal(got, jgen.generate_voxel_with_id(cloud))
    voxels, coords, _, vid, nv = got
    assert gen.grid_size == (16, 64, 64) and int(nv) == 1500
    valid = coords[:, :1] >= 0
    feats = torch.cat([voxels[:, 0], torch.ones_like(voxels[:, 0, :2])], 1)
    feats[:, 4] = 0.0
    feats = torch.where(valid, feats, torch.zeros_like(feats))
    inds = torch.cat([torch.where(valid, 0, -1).int(), coords], 1)
    x = st.SparseConvTensor(feats, inds, gen.grid_size, 1, keys_sorted=True)
    jx = spconv_tpu.SparseConvTensor(
        jnp.asarray(feats.numpy()), jnp.asarray(inds.numpy()),
        gen.grid_size, 1, keys_sorted=True)

    enc = dict(in_channels=5, base_channels=8, channels=(8, 16),
               blocks_per_stage=1, out_channels=16, bn=False,
               out_bounds=(2048,))
    jenc = JaxEncoder(**enc)
    tenc = load_jax_state_dict(SparseEncoder(device="cpu", **enc),
                               state_dict(jenc)).eval()
    with torch.no_grad():
        stages = tenc.forward_stages(x)
        first = torch.relu(tenc.conv_input(x).features)
    jy = jenc.conv_input(jx)
    jfirst = np.maximum(np.asarray(jy.features), 0)
    jout = jenc(jx)
    np.testing.assert_array_equal(stages[-1].indices.numpy(),
                                  np.asarray(jout.indices))
    ref = np.asarray(jout.features)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(stages[-1].features.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    per_point = gather_features_by_pc_voxel_id(first, vid, -1.0)
    want = np.asarray(jax_gather(jnp.asarray(jfirst), jnp.asarray(
        vid.numpy()), -1.0))
    np.testing.assert_allclose(per_point.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert (per_point[vid < 0] == -1.0).all()
