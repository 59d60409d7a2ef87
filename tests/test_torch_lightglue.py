"""The port's LightGlue against the JAX package on the CPU, with JAX's
``random_weights(PRNGKey)`` (256-d, 4 heads, 9 layers) carried across by
``convert.lightglue_from_numpy``:

* the log assignment scores of ``_match_core`` in float64 within 1e-10 of
  their largest magnitude, with matches, counts and match scores equal:
  on a pair with a non-prefix valid mask and per-image sizes, and on a
  pair whose second image has no valid keypoint (JAX's attention there is
  uniform over the masked keys);
* ``match_pair`` in float32: the same matches, scores within 1e-5;
* ``match_all_pairs`` over 6 pairs in batches of 4 (the tail batch
  padded): the same matches for every pair;
* the JAX tests' semantic bars (an identical set matches itself, a
  permuted one is recovered) and their padding test;
* the converter writes JAX's npz from the official checkpoint layout;
* ``generate_database`` with ``superpoint+lightglue`` and
  ``disk+lightglue`` on ``test_torch_learned_features.py``'s images,
  against JAX's database (``db_agree``), no match differing.  With random
  weights LightGlue's match probabilities stay under the handler's 0.1
  threshold on SuperPoint's pairs (in both packages: no match), while
  DISK's copied image passes it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsfm_tpu.features import disk as jdk
from instantsfm_tpu.features import lightglue as jlg
from instantsfm_tpu.features import superpoint as jsp
from instantsfm_tpu.features.handler import generate_database as jgenerate
from instantsfm_tpu_torch import convert
from instantsfm_tpu_torch.features import lightglue as lg
from instantsfm_tpu_torch.features.handler import generate_database
from tests.test_torch_learned_features import (db_agree, numpy_weights,
                                               write_images)


def _quiet(*a, **k):
    pass


@functools.lru_cache(maxsize=None)
def _weights(dtype_name, input_dim=256, seed=3):
    return numpy_weights(jlg.random_weights(
        jax.random.PRNGKey(seed), input_dim, getattr(jnp, dtype_name)))


def _pair(rng, M0, M1, dtype, D=256):
    """Keypoints and unit descriptors; image 1 holds a noisy permutation of
    image 0's first keypoints."""
    k0 = rng.uniform(0, 400, (M0, 2))
    d0 = rng.standard_normal((M0, D))
    perm = rng.permutation(M0)[:M1]
    k1 = k0[perm] + rng.normal(0, 2, (M1, 2))
    d1 = d0[perm] + 0.3 * rng.standard_normal((M1, D))
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    return k0.astype(dtype), d0.astype(dtype), k1.astype(dtype), \
        d1.astype(dtype)


def _jax_scores(k0, d0, m0, k1, d1, m1, s0, s1, w):
    """JAX's ``_match_core`` up to its log assignment (its lines, with the
    module's own blocks)."""
    x0 = jlg._linear(d0, w["input_proj_w"], w["input_proj_b"])
    x1 = jlg._linear(d1, w["input_proj_w"], w["input_proj_b"])
    cos0, sin0 = jlg._posenc(k0, s0, w["posenc_Wr"])
    cos1, sin1 = jlg._posenc(k1, s1, w["posenc_Wr"])
    for i in range(jlg.N_LAYERS):
        x0 = jlg._self_block(x0, cos0, sin0, m0, w, i)
        x1 = jlg._self_block(x1, cos1, sin1, m1, w, i)
        x0, x1 = jlg._cross_block(x0, x1, m0, m1, w, i)
    return jlg._assignment(x0, x1, m0, m1, w)


@functools.partial(jax.jit, static_argnames=("max_matches",))
def _jax_scores_and_core(args, w, threshold, max_matches):
    return _jax_scores(*args, w), jlg._match_core(*args, w, threshold,
                                                  max_matches)


def _run_both(k0, d0, m0, k1, d1, m1, s0, s1, threshold, max_matches):
    w = _weights("float64")
    args = (k0, d0, m0, k1, d1, m1, s0, s1)
    js, (jout, jcount, jmsc) = _jax_scores_and_core(
        tuple(map(jnp.asarray, args)), {k: jnp.asarray(v) for k, v in w.items()},
        threshold, max_matches=max_matches)
    js = np.asarray(js)
    net = convert.lightglue_from_numpy(w, "cpu", torch.float64)
    t = [torch.as_tensor(a)[None] for a in args]
    with torch.no_grad():
        ts = net(*t)
        tout, tcount, tmsc = lg.filter_matches(ts, t[2], t[5], threshold,
                                               max_matches)
    return (js, np.asarray(jout), int(jcount), np.asarray(jmsc)), \
        (ts[0].numpy(), tout[0].numpy(), int(tcount[0]), tmsc[0].numpy())


def _assert_core_equal(want, got, mask):
    js, jout, jcount, jmsc = want
    ts, tout, tcount, tmsc = got
    big = np.abs(js[mask]).max()
    np.testing.assert_allclose(ts[mask], js[mask], rtol=0, atol=1e-10 * big)
    np.testing.assert_allclose(tmsc, jmsc, rtol=1e-10, atol=1e-300)
    assert tcount == jcount
    np.testing.assert_array_equal(tout, jout)


def test_match_core_matches_jax_f64():
    """Non-prefix valid masks on both sides, M0 != M1, per-image sizes."""
    rng = np.random.default_rng(0)
    k0, d0, k1, d1 = _pair(rng, 48, 40, np.float64)
    m0 = rng.uniform(size=48) > 0.25
    m1 = rng.uniform(size=40) > 0.25
    m0[0] = m1[0] = False
    s0, s1 = np.array([400.0, 300.0]), np.array([380.0, 420.0])
    want, got = _run_both(k0, d0, m0, k1, d1, m1, s0, s1, 0.0, 32)
    _assert_core_equal(want, got, m0[:, None] & m1[None, :])
    assert 10 < want[2] <= 32                 # capped at max_matches
    # masked rows and columns carry the -1e30 fill in both packages
    np.testing.assert_array_equal(got[0][~m0] < -1e29, want[0][~m0] < -1e29)


def test_image_without_valid_keypoint_matches_jax():
    """Every key of image 1 masked: its softmax rows are uniform in JAX
    (-1e30 everywhere), as in the port; no match."""
    rng = np.random.default_rng(1)
    k0, d0, k1, d1 = _pair(rng, 48, 40, np.float64)
    m0 = np.ones(48, bool)
    m1 = np.zeros(40, bool)
    s = np.array([400.0, 400.0])
    want, got = _run_both(k0, d0, m0, k1, d1, m1, s, s, 0.1, 32)
    assert want[2] == got[2] == 0
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-10)
    # a zero-weight attention (scaled_dot_product_attention's answer for an
    # all-masked row) would change image 0's messages: held by the scores
    # above; here the port's masked softmax itself is uniform
    logits = torch.zeros((1, 1, 3, 5), dtype=torch.float64)
    p = lg._masked_softmax(logits, torch.zeros((1, 5), dtype=torch.bool))
    np.testing.assert_allclose(p.numpy(), 0.2)


def test_match_pair_matches_jax_f32():
    rng = np.random.default_rng(2)
    k0, d0, k1, d1 = _pair(rng, 64, 64, np.float32)
    v0 = rng.uniform(size=64) > 0.1
    v1 = rng.uniform(size=64) > 0.1
    w = _weights("float32")
    cfg = jlg.LightGlueConfig(filter_threshold=0.0)
    mj, sj = jlg.match_pair(k0, d0, v0, k1, d1, v1, (400.0, 400.0), w, cfg,
                            size1=(380.0, 420.0))
    mt, st = lg.match_pair(k0, d0, v0, k1, d1, v1, (400.0, 400.0),
                           convert.lightglue_from_numpy(w, "cpu"),
                           lg.LightGlueConfig(filter_threshold=0.0),
                           size1=(380.0, 420.0), device="cpu")
    assert mt.dtype == np.int32 and len(mj) > 20
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(st, sj, rtol=1e-5)


def test_match_all_pairs_matches_jax():
    """4 images of 32 keypoints (image 3 with half its slots invalid), 6
    pairs in batches of 4: the second batch is padded with its last pair."""
    rng = np.random.default_rng(3)
    base_k, base_d, _, _ = _pair(rng, 32, 32, np.float32)
    kps, descs, valids = [], [], []
    for i in range(4):
        perm = rng.permutation(32)
        kps.append((base_k[perm] + rng.normal(0, 1, (32, 2)))
                   .astype(np.float32))
        d = base_d[perm] + 0.2 * rng.standard_normal((32, 256))
        descs.append((d / np.linalg.norm(d, axis=1, keepdims=True))
                     .astype(np.float32))
        valids.append(np.arange(32) % 2 == 0 if i == 3 else np.ones(32, bool))
    sizes = np.array([[400, 400], [400, 380], [420, 400], [400, 400]],
                     np.float32)
    w = _weights("float32")
    cfg = jlg.LightGlueConfig(filter_threshold=0.02)
    want = jlg.match_all_pairs(kps, descs, valids, sizes, w, cfg=cfg, batch=4)
    got = lg.match_all_pairs(kps, descs, valids, sizes,
                             convert.lightglue_from_numpy(w, "cpu"),
                             cfg=lg.LightGlueConfig(filter_threshold=0.02),
                             batch=4, device="cpu")
    assert sorted(got) == sorted(want) and len(got) == 6
    for p in want:
        np.testing.assert_array_equal(got[p], want[p])
    assert sum(len(m) for m in got.values()) > 30


def test_identical_and_permuted_sets():
    """``tests/test_lightglue.py``'s bars on the port: an identical set of
    64 matches itself, a permuted copy is recovered."""
    net = convert.lightglue_from_numpy(_weights("float32", seed=1), "cpu")
    rng = np.random.default_rng(0)
    kp = rng.uniform(0, 400, (64, 2)).astype(np.float32)
    d = rng.standard_normal((64, 256)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v = np.ones(64, bool)
    cfg = lg.LightGlueConfig(filter_threshold=0.0)
    m, _ = lg.match_pair(kp, d, v, kp, d, v, (400.0, 400.0), net, cfg,
                         device="cpu")
    assert len(m) >= 56 and np.mean(m[:, 0] == m[:, 1]) > 0.95
    perm = rng.permutation(64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(64)
    m, _ = lg.match_pair(kp, d, v, kp[perm], d[perm], v, (400.0, 400.0), net,
                         cfg, device="cpu")
    assert np.mean(m[:, 1] == inv[m[:, 0]]) > 0.9
    # padded keypoints never match and leave the valid ones' matches alone
    kp2 = np.concatenate([kp, rng.uniform(0, 400, (16, 2)).astype(np.float32)])
    d2 = np.concatenate([d, rng.standard_normal((16, 256)).astype(np.float32)])
    v2 = np.concatenate([v, np.zeros(16, bool)])
    m_ref, _ = lg.match_pair(kp, d, v, kp, d, v, (400.0, 400.0), net, cfg,
                             device="cpu")
    m_pad, _ = lg.match_pair(kp2, d2, v2, kp2, d2, v2, (400.0, 400.0), net,
                             cfg, device="cpu")
    assert (m_pad < 64).all()
    assert len({tuple(r) for r in m_ref} & {tuple(r) for r in m_pad}) \
        >= 0.9 * len(m_ref)


def _official_state_dict(rng):
    """The official LightGlue checkpoint's key names and shapes."""
    sd = {"input_proj.weight": torch.tensor(
              rng.standard_normal((256, 256)).astype(np.float32) * 0.05),
          "input_proj.bias": torch.zeros(256),
          "posenc.Wr.weight": torch.tensor(
              rng.standard_normal((32, 2)).astype(np.float32))}
    for i in range(lg.N_LAYERS):
        t = f"transformers.{i}"
        for name, shape in [("self_attn.Wqkv", (768, 256)),
                            ("self_attn.out_proj", (256, 256)),
                            ("self_attn.ffn.0", (512, 512)),
                            ("self_attn.ffn.1", (512,)),
                            ("self_attn.ffn.3", (256, 512)),
                            ("cross_attn.to_qk", (256, 256)),
                            ("cross_attn.to_v", (256, 256)),
                            ("cross_attn.to_out", (256, 256)),
                            ("cross_attn.ffn.0", (512, 512)),
                            ("cross_attn.ffn.1", (512,)),
                            ("cross_attn.ffn.3", (256, 512))]:
            w = (np.ones(shape, np.float32) if len(shape) == 1 else
                 rng.standard_normal(shape).astype(np.float32) * 0.02)
            sd[f"{t}.{name}.weight"] = torch.tensor(w)
            sd[f"{t}.{name}.bias"] = torch.tensor(
                rng.standard_normal(shape[0]).astype(np.float32) * 0.01)
        sd[f"log_assignment.{i}.final_proj.weight"] = torch.tensor(
            rng.standard_normal((256, 256)).astype(np.float32) * 0.05)
        sd[f"log_assignment.{i}.final_proj.bias"] = torch.zeros(256)
        sd[f"log_assignment.{i}.matchability.weight"] = torch.tensor(
            rng.standard_normal((1, 256)).astype(np.float32))
        sd[f"log_assignment.{i}.matchability.bias"] = torch.zeros(1)
    return {"state_dict": {f"matcher.{k}": v for k, v in sd.items()}}


def test_converter_writes_jax_npz(tmp_path):
    pth = str(tmp_path / "superpoint_lightglue.pth")
    torch.save(_official_state_dict(np.random.default_rng(8)), pth)
    a = jlg.convert_torch_checkpoint(pth, str(tmp_path / "j.npz"))
    b = lg.convert_torch_checkpoint(pth, str(tmp_path / "t.npz"))
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype
            np.testing.assert_array_equal(za[k], zb[k])
    # the npz builds the port's module with every array in a parameter
    net = convert.lightglue_from_numpy(lg.load_weights(b), "cpu")
    assert len(net.state_dict()) == len(lg.load_weights(b))
    assert set(lg.load_weights(b)) == set(_weights("float32"))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_images(str(tmp_path_factory.mktemp("lg")))


@pytest.mark.parametrize("feature_name", ["superpoint+lightglue",
                                          "disk+lightglue"])
def test_generate_database_matches_jax(feature_name, scene, tmp_path,
                                       monkeypatch):
    extractor = feature_name.split("+")[0]
    jmod = jsp if extractor == "superpoint" else jdk
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("ext", "lg")}
    np.savez(paths["ext"], **numpy_weights(
        jmod.random_weights(jax.random.PRNGKey(4))))
    np.savez(paths["lg"], **_weights("float32", jmod.DESC_DIM, seed=5))
    monkeypatch.setenv(f"INSTANTSFM_{extractor.upper()}_WEIGHTS", paths["ext"])
    monkeypatch.setenv("INSTANTSFM_LIGHTGLUE_WEIGHTS", paths["lg"])
    dbs = {}
    for pkg, fn in (("jax", jgenerate), ("port", generate_database)):
        dbs[pkg] = str(tmp_path / f"{pkg}.db")
        kw = dict(device="cpu") if pkg == "port" else {}
        fn(scene, dbs[pkg], feature_name=feature_name, max_keypoints=128,
           min_num_matches=5, log=_quiet, **kw)
    _, n_matches, n_differ = db_agree(dbs["jax"], dbs["port"])
    assert n_differ == 0
    # random weights: DISK's copied image passes LightGlue's 0.1 threshold
    # in both packages, SuperPoint's pairs do not
    assert n_matches > (50 if extractor == "disk" else -1)
