"""The port's recorder, viewers and their CLIs against the JAX package's.

One seeded scene of random cameras and tracks feeds both packages'
``ReconstructionVisualizer.add_step`` (the npz snapshots must hold equal
arrays), ``OfflinePlayer`` (steps and final colours) and the live-server
path with a stub ``viser`` module.  ``write_html_view``'s JSON payload is
held to JAX's on one model within 1e-12.  ``cli.sfm --record_recon
--enable_gui`` runs on the CPU on a 14-image ``chip_smoke.write_ring_db``
scene (viser absent): 4 recorded steps with the JAX mapper's stage names,
then ``cli.vis`` replays them to a video (matplotlib is installed here)."""

import glob
import json
import os
import sys
import time
import types

import numpy as np
import pytest

import chip_smoke
from instantsfm_tpu.cli import demo as jax_demo
from instantsfm_tpu.scene import types as jax_types
from instantsfm_tpu.vis import visualizer as jax_vis
from instantsfm_tpu_torch.cli import demo, sfm as cli_sfm, vis as cli_vis
from instantsfm_tpu_torch.io import colmap_model as cmio
from instantsfm_tpu_torch.scene import types as port_types
from instantsfm_tpu_torch.vis import pose3d, visualizer

QUIET = lambda *a, **k: None
STAGES = ["global_positioning"] + ["bundle_adjustment"] * 3


def _scene(pkg_types, arrays):
    n, t = len(arrays["qvec"]), len(arrays["xyz"])
    images = pkg_types.Images(
        cam_idx=np.zeros(n, np.int32), names=[f"im{i}" for i in range(n)],
        qvec=arrays["qvec"], tvec=arrays["tvec"],
        registered=arrays["registered"], cluster_id=np.full(n, -1, np.int32),
        kp_xy=np.zeros((0, 2)), kp_offset=np.zeros(n + 1, np.int64))
    tracks = pkg_types.Tracks(
        xyz=arrays["xyz"], color=arrays["color"],
        obs_image=np.zeros(0, np.int32), obs_feature=np.zeros(0, np.int32),
        obs_offset=np.zeros(t + 1, np.int64), track_id=np.arange(t))
    return images, tracks


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Both packages record the same two steps of one seeded scene."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((6, 4))
    arrays = dict(qvec=q / np.linalg.norm(q, axis=1, keepdims=True),
                  tvec=rng.standard_normal((6, 3)),
                  registered=np.array([1, 1, 0, 1, 1, 1], bool),
                  xyz=rng.standard_normal((40, 3)),
                  color=rng.integers(0, 256, (40, 3)).astype(np.uint8))
    out = {}
    for pkg, vis_mod, pkg_types in (("jax", jax_vis, jax_types),
                                    ("port", visualizer, port_types)):
        root = tmp_path_factory.mktemp(pkg)
        viz = vis_mod.ReconstructionVisualizer(save_data=True,
                                               save_dir=str(root), log=QUIET)
        images, tracks = _scene(pkg_types, arrays)
        for stage in STAGES[:2]:
            viz.add_step(None, images, tracks, stage)
        out[pkg] = glob.glob(str(root / "session_*"))[0]
    out["arrays"] = arrays
    return out


def test_add_step_npz_matches_jax(recorded):
    steps = [sorted(os.listdir(recorded[p])) for p in ("port", "jax")]
    assert steps[0] == steps[1] == ["step_0000.npz", "step_0001.npz"]
    for name in steps[0]:
        a = np.load(os.path.join(recorded["port"], name))
        b = np.load(os.path.join(recorded["jax"], name))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12) \
                if k == "centers" else np.testing.assert_array_equal(a[k], b[k])
    assert len(a["centers"]) == 5


def _final_model(path, arrays):
    pts = [cmio.ModelPoint3D(i + 1, arrays["xyz"][i], arrays["color"][i], 0.5,
                             np.zeros(0, np.int64), np.zeros(0, np.int64))
           for i in range(len(arrays["xyz"]))]
    cams = [cmio.ModelCamera(1, 1, 64, 48, np.array([50., 50, 32, 24]))]
    imgs = [cmio.ModelImage(i + 1, np.r_[q[3], q[:3]], t, 1, f"im{i}.png",
                            np.zeros((0, 2)), np.zeros(0, np.int64))
            for i, (q, t) in enumerate(zip(arrays["qvec"], arrays["tvec"]))]
    cmio.write_model(cams, imgs, pts, path)
    return path


def test_offline_player_matches_jax(recorded, tmp_path):
    model = _final_model(str(tmp_path / "model"), recorded["arrays"])
    port = visualizer.OfflinePlayer(recorded["port"], model, log=QUIET)
    ref = jax_vis.OfflinePlayer(recorded["jax"], model, log=QUIET)
    assert len(port) == len(ref) == 2
    np.testing.assert_array_equal(port.final_colors, ref.final_colors)
    np.testing.assert_array_equal(port.final_colors, recorded["arrays"]["color"])
    for i in range(2):
        a, b = port.load_step(i), ref.load_step(i)
        assert str(a["stage"]) == str(b["stage"]) == STAGES[i]
        np.testing.assert_array_equal(a["points"], b["points"])
    out = port.export_video(str(tmp_path / "replay.mp4"), fps=2)
    assert os.path.getsize(out) > 0
    with pytest.raises(FileNotFoundError):
        visualizer.OfflinePlayer(str(tmp_path / "none"), log=QUIET)


def test_export_video_names_matplotlib_where_missing(recorded, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    player = visualizer.OfflinePlayer(recorded["port"], log=QUIET)
    with pytest.raises(ImportError, match="matplotlib"):
        player.export_video("unused.mp4")


def _stub_viser(calls):
    class Scene:
        def add_point_cloud(self, name, points, colors, point_size):
            calls.append(("points", name, points.copy(), colors.copy(),
                          point_size))

        def add_camera_frustum(self, name, fov, aspect, scale, wxyz,
                               position):
            calls.append(("frustum", name, np.asarray(wxyz),
                          np.asarray(position)))

    class ViserServer:
        def __init__(self):
            self.scene = Scene()

    mod = types.ModuleType("viser")
    mod.ViserServer = ViserServer
    mod.transforms = types.ModuleType("viser.transforms")
    return mod


def test_live_server_matches_jax(recorded, monkeypatch):
    """The live path with a stub viser: both packages' update threads send
    the same point cloud and frusta for the same step."""
    sent = {}
    arrays = recorded["arrays"]
    for pkg, vis_mod, pkg_types in (("jax", jax_vis, jax_types),
                                    ("port", visualizer, port_types)):
        calls = []
        stub = _stub_viser(calls)
        monkeypatch.setitem(sys.modules, "viser", stub)
        monkeypatch.setitem(sys.modules, "viser.transforms", stub.transforms)
        viz = vis_mod.ReconstructionVisualizer(serve=True,
                                               update_interval=0.01, log=QUIET)
        viz.add_step(None, *_scene(pkg_types, arrays), "global_positioning")
        deadline = time.time() + 30
        while len(calls) < 6 and time.time() < deadline:
            time.sleep(0.01)
        viz._stop.set()
        viz._thread.join(timeout=30)
        assert not viz._thread.is_alive()
        sent[pkg] = calls[:6]
    assert [c[:2] for c in sent["port"]] == [c[:2] for c in sent["jax"]]
    assert [c[1] for c in sent["port"]] == ["/points"] + [
        f"/cams/{i}" for i in range(5)]
    for a, b in zip(sent["port"], sent["jax"]):
        for x, y in zip(a[2:], b[2:]):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)


def test_html_payload_matches_jax(recorded, tmp_path):
    model = _final_model(str(tmp_path / "model"), recorded["arrays"])
    a = demo._scene_payload(model, device="cpu")
    b = jax_demo._scene_payload(model)
    assert a.keys() == b.keys() and len(a["cameras"]) == 6
    for k in a:
        np.testing.assert_allclose(np.array(a[k], float), np.array(b[k], float),
                                   rtol=0, atol=1e-12)
    out = str(tmp_path / "view.html")
    assert pose3d.main(["--sparse_dir", model, "--export_html", out,
                        "--device", "cpu"]) == 0
    with open(out) as f:
        html = f.read()
    payload = json.loads(html.split("const data = ", 1)[1].split(";\n", 1)[0])
    assert payload == json.loads(json.dumps(a))


def test_cli_sfm_records_and_cli_vis_replays(tmp_path, monkeypatch, capsys):
    scene = tmp_path / "scene"
    scene.mkdir()
    chip_smoke.write_ring_db(str(scene / "database.db"), num_cams=14,
                             num_pts=600, window=6)
    monkeypatch.setitem(sys.modules, "viser", None)
    assert cli_sfm.main(["--data_path", str(scene), "--device", "cpu",
                         "--record_recon", "--enable_gui"]) == 0
    assert "viser is not installed" in capsys.readouterr().out
    sessions = glob.glob(str(scene / "record" / "session_*"))
    assert len(sessions) == 1
    player = visualizer.OfflinePlayer(sessions[0], log=QUIET)
    assert [str(player.load_step(i)["stage"]) for i in range(len(player))] \
        == STAGES
    _, imgs, pts = cmio.read_model(str(scene / "sparse" / "0"))
    last = player.load_step(len(player) - 1)
    assert len(last["centers"]) == len(imgs) == 14
    assert len(pts) > 100 and player.final_colors is None
    video = str(tmp_path / "replay.mp4")
    assert cli_vis.main(["--data_path", str(scene), "--export_video",
                         video, "--fps", "2"]) == 0
    assert "loaded 4 steps" in capsys.readouterr().out
    assert glob.glob(str(tmp_path / "replay.*"))
