"""Port parity for file I/O: the port's PNG codec against imageio, and the
port's COLMAP model reader/writer against the JAX package's, both ways,
binary and text.  Exact comparisons: both sides read and write the same
bytes and numbers."""

import sys

import imageio.v3 as iio
import numpy as np
import pytest

from instantsfm_tpu.io import colmap_model as jcm
from instantsfm_tpu_torch.io import colmap_model as tcm
from instantsfm_tpu_torch.io import image as timg


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_matches_imageio(tmp_path, channels, filter_type):
    rng = np.random.default_rng(10 * channels + filter_type)
    shape = (23, 37) if channels == 1 else (23, 37, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[:5] = 200                     # flat rows: small filtered residuals
    path = str(tmp_path / "a.png")
    timg.imwrite(path, img, filter_type=filter_type)
    np.testing.assert_array_equal(iio.imread(path), img)
    np.testing.assert_array_equal(timg.imread(path), img)
    iio.imwrite(path, img)            # imageio's own filter choice
    np.testing.assert_array_equal(timg.imread(path), img)


def test_png_single_pixel_and_column(tmp_path):
    for shape in [(1, 1, 3), (9, 1, 3), (1, 9)]:
        img = np.arange(np.prod(shape), dtype=np.uint8).reshape(shape) * 7
        path = str(tmp_path / "b.png")
        for f in range(5):
            timg.imwrite(path, img, filter_type=f)
            np.testing.assert_array_equal(iio.imread(path), img)
            np.testing.assert_array_equal(timg.imread(path), img)


def test_other_formats_need_imageio(tmp_path, monkeypatch):
    img = np.zeros((4, 4, 3), np.uint8)
    timg.imwrite(str(tmp_path / "c.bmp"), img)          # through imageio
    np.testing.assert_array_equal(timg.imread(str(tmp_path / "c.bmp")), img)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(RuntimeError, match=r"\.jpg"):
        timg.imread(str(tmp_path / "d.jpg"))
    timg.imwrite(str(tmp_path / "e.png"), img)          # PNG needs nothing
    np.testing.assert_array_equal(timg.imread(str(tmp_path / "e.png")), img)


def _model(m, rng):
    """A small model in package ``m``'s record types: three camera models,
    images with keypoints (some without a 3D point), points with tracks."""
    cams = [m.ModelCamera(1, 1, 640, 480, np.array([500.0, 510.0, 320, 240])),
            m.ModelCamera(2, 2, 800, 600, np.array([700.0, 400, 300, 0.01])),
            m.ModelCamera(5, 4, 320, 240, rng.uniform(-1, 300, 8))]
    imgs = []
    for i in range(4):
        n = 3 + i
        q = rng.standard_normal(4)
        imgs.append(m.ModelImage(
            10 + i, q / np.linalg.norm(q), rng.standard_normal(3),
            cams[i % 3].id, f"img_{i:02d}.png", rng.uniform(0, 600, (n, 2)),
            np.where(np.arange(n) % 2 == 0, np.arange(n) + 100, -1)))
    pts = [m.ModelPoint3D(100 + p, rng.standard_normal(3),
                          rng.integers(0, 256, 3).astype(np.uint8),
                          float(rng.uniform(0, 2)),
                          np.array([10, 11, 13][:1 + p % 3]),
                          np.array([0, 2, 4][:1 + p % 3])) for p in range(7)]
    return cams, imgs, pts


def _assert_same_model(a, b):
    (ca, ia, pa), (cb, ib, pb) = a, b
    assert sorted(ca) == sorted(cb) and sorted(ia) == sorted(ib) \
        and sorted(pa) == sorted(pb)
    for k in ca:
        assert (ca[k].id, ca[k].model_id, ca[k].width, ca[k].height) == (
            cb[k].id, cb[k].model_id, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
    for k in ia:
        assert (ia[k].id, ia[k].camera_id, ia[k].name) == (
            ib[k].id, ib[k].camera_id, ib[k].name)
        for f in ("qvec_wxyz", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(ia[k], f),
                                          getattr(ib[k], f))
    for k in pa:
        assert pa[k].error == pb[k].error
        for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            np.testing.assert_array_equal(getattr(pa[k], f),
                                          getattr(pb[k], f))


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_colmap_model_matches_jax(tmp_path, writer, binary):
    """Write with one package, read with both: the same records."""
    rng = np.random.default_rng(int(binary))
    w = jcm if writer == "jax" else tcm
    w.write_model(*_model(w, rng), str(tmp_path), binary=binary)
    _assert_same_model(tcm.read_model(str(tmp_path)),
                       jcm.read_model(str(tmp_path)))
    if writer == "port":
        jdir = tmp_path / "jax"
        jcm.write_model(*_model(jcm, np.random.default_rng(int(binary))),
                        str(jdir), binary=binary)
        for name in ("cameras", "images", "points3D"):
            ext = ".bin" if binary else ".txt"
            assert (tmp_path / (name + ext)).read_bytes() == \
                (jdir / (name + ext)).read_bytes()
