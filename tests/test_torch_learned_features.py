"""The learned extractors of the port (SuperPoint, DISK, DeDoDe) against
the JAX package on the CPU, with the same JAX ``random_weights(PRNGKey)``
carried across by ``convert.*_from_numpy``:

* the forward maps in float64 on both sides, within 1e-10 of each map's
  largest entry;
* ``extract`` in float32, as JAX runs it, on a 96x128 image with 1,024
  keypoints (more than each finds, so the invalid slots are filled from
  the tied zeros or -inf left by the NMS): the invalid slots equal; the
  same valid keypoints, scores within 1e-5 of the largest, in the same
  slots up to float32 ties (``chip_smoke.keypoints_agree``: two keypoints
  whose scores tie within twice that may trade slots; convolutions summed
  in another order move a score by about 1e-6), descriptors within 1e-5;
* ``top_k`` and the three NMS variants on exact ties, and DeDoDe's 2x
  bilinear upsampling against ``jax.image.resize``;
* each converter writes JAX's npz from the same synthetic state dict;
* ``generate_database`` with ``device="cpu"`` for ``superpoint``,
  ``superpoint_tpu``, ``disk`` and ``dedode`` on three small images:
  the same keypoints (each image's keypoint rows may differ in order where
  scores tie), stored descriptor bytes within one level, and the same
  matches but for at most 1% decided within float32 rounding of the ratio
  test's threshold (``db_agree``);
* the missing-weight errors, and ``cli.feat`` with learned names.
"""

import functools
import os
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from instantsfm_tpu.features import dedode as jdd
from instantsfm_tpu.features import disk as jdk
from instantsfm_tpu.features import superpoint as jsp
from instantsfm_tpu.features.handler import generate_database as jgenerate
from instantsfm_tpu_torch import convert
from instantsfm_tpu_torch.features import dedode, disk, superpoint
from instantsfm_tpu_torch.features.handler import generate_database, load_gray
from instantsfm_tpu_torch.io.image import imwrite

KP = 1024
RGB = {"superpoint": False, "disk": True, "dedode": True}
PAIRS = {"superpoint": (jsp, superpoint, convert.superpoint_from_numpy,
                        "SuperPointConfig"),
         "disk": (jdk, disk, convert.disk_from_numpy, "DiskConfig"),
         "dedode": (jdd, dedode, convert.dedode_from_numpy, "DeDoDeConfig")}
ENV = {"superpoint": "INSTANTSFM_SUPERPOINT_WEIGHTS",
       "disk": "INSTANTSFM_DISK_WEIGHTS",
       "dedode": "INSTANTSFM_DEDODE_WEIGHTS"}
SEEDS = {"superpoint": 0, "disk": 1, "dedode": 2}


def _quiet(*a, **k):
    pass


def numpy_weights(w):
    return {k: np.asarray(v) for k, v in w.items()}


def write_images(root):
    """Three 96x128 RGB crops of one noise texture: two 8 px apart and a
    copy of the first (a pair with every keypoint in common)."""
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    tex = np.random.default_rng(0).uniform(0, 255, (160, 200, 3)) \
        .astype(np.uint8)
    for i, o in enumerate((0, 8, 0)):
        imwrite(os.path.join(img_dir, f"im{i}.png"),
                tex[o:o + 96, o:o + 128])
    return img_dir


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_images(str(tmp_path_factory.mktemp("learned")))


# ------------------------------------------------------------ forward maps

@functools.lru_cache(maxsize=None)
def _forward64(name):
    """(weights f64, image, JAX's two maps) for a 48x64 image."""
    jmod = PAIRS[name][0]
    w = numpy_weights(jmod.random_weights(jax.random.PRNGKey(SEEDS[name]),
                                          jnp.float64))
    rng = np.random.default_rng(SEEDS[name])
    img = rng.uniform(0, 1, (48, 64, 3) if RGB[name] else (48, 64))
    if name == "dedode":
        fn = jax.jit(lambda i, w: (jdd.detector_logits(i, w),
                                   jdd.descriptor_field(i, w)))
    else:
        fn = jax.jit(jmod.forward)
    return w, img, [np.asarray(a) for a in fn(jnp.asarray(img), w)]


@pytest.mark.parametrize("name", list(PAIRS))
def test_forward_matches_jax_f64(name):
    w, img, want = _forward64(name)
    net = PAIRS[name][2](w, "cpu", torch.float64)
    with torch.no_grad():
        x = torch.as_tensor(img)
        got = ((net.detector_logits(x), net.descriptor_field(x))
               if name == "dedode" else net(x))
    for g, t in zip(got, want, strict=True):
        assert g.dtype == torch.float64 and g.shape == t.shape
        np.testing.assert_allclose(g.numpy(), t, rtol=0,
                                   atol=1e-10 * np.abs(t).max())


# ------------------------------------------------------------ extraction

def _extract_pair(name, img_dir):
    """JAX's and the port's float32 ``extract`` on the first image, with
    the weights both packages load in ``generate_database`` below."""
    jmod, mod, build, cfg_name = PAIRS[name]
    w = numpy_weights(jmod.random_weights(jax.random.PRNGKey(SEEDS[name])))
    img, _, _ = load_gray(os.path.join(img_dir, "im0.png"), 1600,
                          rgb=RGB[name])
    want = jmod.extract(img, w, getattr(jmod, cfg_name)(max_keypoints=KP))
    got = mod.extract(img, build(w, "cpu"),
                      getattr(mod, cfg_name)(max_keypoints=KP), device="cpu")
    return want, got


@pytest.mark.parametrize("name", list(PAIRS))
def test_extract_matches_jax(name, scene):
    want, got = _extract_pair(name, scene)
    for a, b in zip(want, got, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
    # the invalid slots: the NMS's exact ties (0, -inf) in index order
    tied = (want[1] == 0) | np.isneginf(want[1])
    assert 50 < tied.sum() < KP - 50
    np.testing.assert_array_equal(got[1][tied], want[1][tied])
    np.testing.assert_array_equal(got[0][tied], want[0][tied])
    agree = chip_smoke.keypoints_agree(want, got, desc_tol=1e-5,
                                       score_rtol=1e-5)
    assert agree["failures"] == [] and agree["keypoints_in_one_run"] == 0
    n = np.linalg.norm(got[2][got[3]], axis=-1)
    np.testing.assert_allclose(n, 1.0, atol=1e-5)


def test_top_k_orders_ties_like_lax():
    for vals in ([1.0, 3, 3, 3, 0, 3], [0.0] * 7 + [2.0, 0.0],
                 [-np.inf, 1.0, -np.inf, -np.inf, 0.5, -np.inf]):
        a = np.asarray(vals, np.float32)
        for k in (1, 3, len(a)):
            v, i = superpoint.top_k(torch.as_tensor(a), k)
            vj, ij = jax.lax.top_k(jnp.asarray(a), k)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
            np.testing.assert_array_equal(v.numpy(), np.asarray(vj))


@pytest.mark.parametrize("name", list(PAIRS))
def test_nms_ties_like_jax(name):
    """Plateaus of equal values (all kept), a weaker neighbour inside the
    window (suppressed) and the image border."""
    heat = np.full((24, 32), 0.1, np.float32)
    heat[5, 5] = heat[5, 6] = 1.0
    heat[5, 8] = 0.9
    heat[0, 31] = heat[23, 0] = 0.7
    heat[12:15, 12:15] = 0.5
    args = {"superpoint": (4,), "disk": (5,), "dedode": (3,)}[name]
    got = PAIRS[name][1]._nms(torch.as_tensor(heat), *args).numpy()
    want = np.asarray(PAIRS[name][0]._nms(jnp.asarray(heat), *args))
    np.testing.assert_array_equal(got, want)


def test_dedode_up2_matches_jax_resize():
    """``F.interpolate`` bilinear (half-pixel centres) at 2x equals
    ``jax.image.resize`` bilinear, on sizes that are multiples of 8 (as
    DeDoDe's maps are) and on odd ones."""
    rng = np.random.default_rng(3)
    for h, w in ((8, 16), (24, 40), (7, 5)):
        x = rng.standard_normal((1, h, w, 3))
        want = np.asarray(jdd._up2(jnp.asarray(x)))
        got = dedode.up2(torch.as_tensor(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=0, atol=1e-12)


# ------------------------------------------------------------ converters

def _superpoint_state_dict(rng):
    """``superpoint_v1.pth``'s layout: flat ``convXy.weight`` OIHW."""
    shapes = {"conv1a": (64, 1, 3, 3), "conv1b": (64, 64, 3, 3),
              "conv2a": (64, 64, 3, 3), "conv2b": (64, 64, 3, 3),
              "conv3a": (128, 64, 3, 3), "conv3b": (128, 128, 3, 3),
              "conv4a": (128, 128, 3, 3), "conv4b": (128, 128, 3, 3),
              "convPa": (256, 128, 3, 3), "convPb": (65, 256, 1, 1),
              "convDa": (256, 128, 3, 3), "convDb": (256, 256, 1, 1)}
    sd = {}
    for name, s in shapes.items():
        sd[f"{name}.weight"] = torch.tensor(
            rng.standard_normal(s).astype(np.float32) * 0.05)
        sd[f"{name}.bias"] = torch.tensor(
            rng.standard_normal(s[0]).astype(np.float32) * 0.01)
    return sd


def _disk_state_dict(rng):
    """The official DISK export's order: 9 convs in definition order, a
    PReLU gate before every conv but the first."""
    sd = {}
    widths = [(3, 16), (16, 32), (32, 64), (64, 64), (64, 64), (128, 64),
              (128, 64), (96, 64), (80, 129)]
    for i, (cin, cout) in enumerate(widths):
        if i:
            sd[f"unet.blocks.{i}.gate.weight"] = torch.tensor(
                rng.uniform(0.1, 0.4, cin).astype(np.float32))
        sd[f"unet.blocks.{i}.conv.weight"] = torch.tensor(
            rng.standard_normal((cout, cin, 5, 5)).astype(np.float32) * 0.05)
        sd[f"unet.blocks.{i}.conv.bias"] = torch.tensor(
            rng.standard_normal(cout).astype(np.float32) * 0.01)
    return {"extractor": sd}


def _dedode_state_dict(seed, head, enc_ch=(4, 8, 12, 16), hid=(16, 12, 8, 4),
                       ctx=2, hb=1):
    """A small network of DeDoDe's documented structure (BN after every
    encoder conv and every refiner 5x5, depthwise hidden blocks), with
    random BN statistics."""
    nn = torch.nn
    torch.manual_seed(seed)
    mods, cin = [], 3
    for c in enc_ch:
        mods += [nn.Conv2d(cin, c, 3, padding=1), nn.BatchNorm2d(c)]
        cin = c
    cprev = 0
    for si, s in enumerate((8, 4, 2, 1)):
        rin = enc_ch[3 - si] + cprev
        for j in range(hb + 1):
            mods += [nn.Conv2d(rin if j == 0 else hid[si], hid[si], 5,
                               padding=2, groups=hid[si] if j else 1),
                     nn.BatchNorm2d(hid[si]), nn.Conv2d(hid[si], hid[si], 1)]
        cprev = 0 if s == 1 else ctx
        mods.append(nn.Conv2d(hid[si], head + cprev, 1))
    net = nn.Sequential(*mods)
    for m in net.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.normal_()
            m.running_var.uniform_(0.5, 2.0)
            m.weight.data.normal_(1.0, 0.1)
            m.bias.data.normal_()
    return net.state_dict()


def _npz_equal(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape
            np.testing.assert_array_equal(za[k], zb[k])
        return len(za.files)


@pytest.mark.parametrize("name", list(PAIRS))
def test_converter_writes_jax_npz(name, tmp_path):
    rng = np.random.default_rng(4)
    jmod, mod = PAIRS[name][:2]
    if name == "dedode":
        det, desc = str(tmp_path / "det.pth"), str(tmp_path / "desc.pth")
        torch.save(_dedode_state_dict(0, 1), det)
        torch.save(_dedode_state_dict(1, 6), desc)
        args = (det, desc)
    else:
        pth = str(tmp_path / "ckpt.pth")
        torch.save(_superpoint_state_dict(rng) if name == "superpoint"
                   else _disk_state_dict(rng), pth)
        args = (pth,)
    a = jmod.convert_torch_checkpoint(*args, out_path=str(tmp_path / "j.npz"))
    b = mod.convert_torch_checkpoint(*args, out_path=str(tmp_path / "t.npz"))
    assert _npz_equal(a, b) > 10
    # the npz builds the port's module: every array lands in a parameter
    net = PAIRS[name][2](mod.load_weights(b), "cpu")
    n_arrays = sum(np.asarray(v).ndim > 0
                   for v in mod.load_weights(b).values())
    assert len(net.state_dict()) == n_arrays


def test_converters_raise_like_jax(tmp_path):
    sd = _dedode_state_dict(0, 1)
    key = [k for k, v in sd.items()
           if k.endswith("weight") and v.ndim == 4][-1]
    bad = {k: v for k, v in sd.items() if k != key}
    for fn in (jdd._convert_one, dedode._convert_one):
        with pytest.raises(ValueError, match="does not factor"):
            fn(bad, "det", {})
    pth = str(tmp_path / "short.pth")
    sd = _disk_state_dict(np.random.default_rng(5))["extractor"]
    torch.save({k: v for k, v in sd.items() if "blocks.8." not in k}, pth)
    for fn in (jdk.convert_torch_checkpoint, disk.convert_torch_checkpoint):
        with pytest.raises(ValueError, match="expected 9 conv layers"):
            fn(pth, str(tmp_path / "x.npz"))


# ------------------------------------------------------------ databases

def _tables(dbpath):
    with sqlite3.connect(dbpath) as conn:
        q = lambda sql: conn.execute(sql).fetchall()
        return dict(
            cameras=q("SELECT * FROM cameras ORDER BY 1"),
            images=q("SELECT * FROM images ORDER BY 1"),
            feature_name=q("SELECT * FROM feature_name"),
            keypoints=q("SELECT image_id, rows, cols, data FROM keypoints "
                        "ORDER BY 1"),
            descriptors=q("SELECT image_id, rows, cols, data FROM descriptors "
                          "ORDER BY 1"),
            matches=q("SELECT pair_id, rows, data FROM matches ORDER BY 1"),
            geometries=q("SELECT pair_id, rows, data, config FROM "
                         "two_view_geometries ORDER BY 1"))


def db_agree(db_jax, db_port, max_match_share=0.01):
    """The port's database against JAX's: the same cameras, images and
    feature name; per image the same keypoints, whose rows may come in
    another order only where the scores tie (the map between the two row
    orders is built from the keypoints' coordinates); the stored
    descriptor bytes within one level, differing in under 0.1% of them;
    the same pairs in ``matches`` and ``two_view_geometries``, with the
    same matches through that map but for at most ``max_match_share`` of
    them: a ratio test decided within float32 rounding of its threshold
    (e.g. d1/d2 = 0.95003 in JAX, 0.94999 in the port) or a mutual nearest
    neighbour among near-equal similarities.  Returns (rows in another
    order, matches, matches that differ)."""
    tj, tt = _tables(db_jax), _tables(db_port)
    for t in ("cameras", "images", "feature_name"):
        assert tt[t] == tj[t], t
    rows = {}
    moved = 0
    for (ij, nj, cj, bj), (it, nt, ct, bt) in zip(
            tj["keypoints"], tt["keypoints"], strict=True):
        assert (ij, nj, cj) == (it, nt, ct)
        kj = np.frombuffer(bj, np.float32).reshape(nj, cj)
        kt = np.frombuffer(bt, np.float32).reshape(nt, ct)
        at = {tuple(k): r for r, k in enumerate(kj)}
        rows[ij] = np.array([at[tuple(k)] for k in kt], np.int64)
        assert len(set(rows[ij].tolist())) == nt
        moved += int(np.sum(rows[ij] != np.arange(nt)))
    for (ij, nj, cj, bj), (it, nt, ct, bt) in zip(
            tj["descriptors"], tt["descriptors"], strict=True):
        assert (ij, nj, cj) == (it, nt, ct)
        dj = np.frombuffer(bj, np.uint8).reshape(nj, cj).astype(int)
        dt = np.frombuffer(bt, np.uint8).reshape(nt, ct).astype(int)
        diff = np.abs(dt - dj[rows[ij]])
        assert diff.max(initial=0) <= 1 and np.mean(diff > 0) < 1e-3

    def pairs(table):
        out = {}
        for pair_id, n, blob, *cfg in table:
            i2 = pair_id % 2147483647
            m = np.frombuffer(blob, np.uint32).reshape(n, 2).astype(np.int64) \
                if n else np.zeros((0, 2), np.int64)
            out[pair_id] = ((pair_id - i2) // 2147483647, i2, m, cfg)
        return out

    n_matches = n_differ = 0
    for kind in ("matches", "geometries"):
        pj, pt = pairs(tj[kind]), pairs(tt[kind])
        assert sorted(pj) == sorted(pt), kind
        for pid, (i1, i2, mj, cfg) in pj.items():
            mt = pt[pid][2]
            assert pt[pid][3] == cfg
            got = {(rows[i1][a], rows[i2][b]) for a, b in mt}
            if kind == "matches":
                n_matches += len(mj)
                n_differ += len(got ^ {tuple(r) for r in mj.tolist()})
    assert n_differ <= max_match_share * n_matches, (n_differ, n_matches)
    return moved, n_matches, n_differ


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """Each extractor's JAX ``random_weights`` as the npz both packages
    load."""
    root = tmp_path_factory.mktemp("weights")
    out = {}
    for name, seed in SEEDS.items():
        out[name] = str(root / f"{name}.npz")
        np.savez(out[name], **numpy_weights(
            PAIRS[name][0].random_weights(jax.random.PRNGKey(seed))))
    return out


@pytest.mark.parametrize("feature_name",
                         ["superpoint", "superpoint_tpu", "disk", "dedode"])
def test_generate_database_matches_jax(feature_name, scene, weight_files,
                                       tmp_path, monkeypatch):
    for name, env in ENV.items():
        monkeypatch.setenv(env, weight_files[name])
    dbs = {}
    for pkg, fn in (("jax", jgenerate), ("port", generate_database)):
        dbs[pkg] = str(tmp_path / f"{pkg}.db")
        kw = dict(device="cpu") if pkg == "port" else {}
        fn(scene, dbs[pkg], feature_name=feature_name, max_keypoints=KP,
           min_num_matches=10, log=_quiet, **kw)
    _, n_matches, _ = db_agree(dbs["jax"], dbs["port"])
    assert n_matches > 50


@pytest.mark.parametrize("feature_name,env,match", [
    ("superpoint", "INSTANTSFM_SUPERPOINT_WEIGHTS", "superpoint_v1.pth"),
    ("superpoint_tpu", "INSTANTSFM_SUPERPOINT_WEIGHTS", "superpoint_v1.pth"),
    ("disk", "INSTANTSFM_DISK_WEIGHTS", "depth-save.pth"),
    ("dedode", "INSTANTSFM_DEDODE_WEIGHTS", "DeDoDe"),
    ("superpoint+lightglue", "INSTANTSFM_LIGHTGLUE_WEIGHTS",
     "superpoint_lightglue.pth"),
    ("disk+lightglue", "INSTANTSFM_LIGHTGLUE_WEIGHTS", "disk_lightglue.pth"),
])
def test_missing_weights_raise_like_jax(feature_name, env, match, tmp_path,
                                        monkeypatch):
    """The weight gate raises ``RuntimeError`` naming the checkpoint and
    the converter, in both packages, before any image is read."""
    monkeypatch.setenv(env, str(tmp_path / "absent.npz"))
    for fn, kw in ((jgenerate, {}), (generate_database, {"device": "cpu"})):
        with pytest.raises(RuntimeError, match=match):
            fn(str(tmp_path), str(tmp_path / "db.db"),
               feature_name=feature_name, **kw)
    with pytest.raises(RuntimeError, match="convert_torch_checkpoint"):
        generate_database(str(tmp_path), str(tmp_path / "db.db"),
                          feature_name=feature_name, device="cpu")


@pytest.mark.parametrize("feature_name",
                         ["dedode+lightglue", "sift+lightglue"])
def test_lightglue_only_after_superpoint_or_disk(feature_name, tmp_path):
    for fn, kw in ((jgenerate, {}), (generate_database, {"device": "cpu"})):
        with pytest.raises(RuntimeError, match="learned front-ends are"):
            fn(str(tmp_path), str(tmp_path / "db.db"),
               feature_name=feature_name, **kw)


@pytest.mark.parametrize("feature_name", ["superpoint_tpu", "dedode",
                                          "disk+lightglue"])
def test_cli_feat_takes_learned_names(feature_name, scene, weight_files,
                                      tmp_path, monkeypatch):
    """``cli.feat --feature_name NAME --device cpu`` writes a database of
    the three images under that feature name."""
    import shutil

    from instantsfm_tpu_torch.cli import feat
    from instantsfm_tpu_torch.features import lightglue
    from instantsfm_tpu_torch.io.colmap_db import read_colmap_database

    for name, env in ENV.items():
        monkeypatch.setenv(env, weight_files[name])
    lg_path = str(tmp_path / "lg.npz")
    np.savez(lg_path, **lightglue.random_weights(
        torch.Generator().manual_seed(0), input_dim=disk.DESC_DIM))
    monkeypatch.setenv("INSTANTSFM_LIGHTGLUE_WEIGHTS", lg_path)
    shutil.copytree(scene, tmp_path / "images")
    assert feat.main(["--data_path", str(tmp_path), "--feature_name",
                      feature_name, "--max_keypoints", "128",
                      "--device", "cpu"]) == 0
    _, _, images, name = read_colmap_database(str(tmp_path / "database.db"))
    assert name == feature_name and images.num_images == 3
    assert len(images.kp_xy) > 3 * 50
