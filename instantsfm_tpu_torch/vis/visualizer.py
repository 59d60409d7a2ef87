"""Live reconstruction visualizer + per-step recorder + offline player.

Counterpart of ``instantsfm_tpu/vis/visualizer.py`` (reference
``controllers/reconstruction_visualizer.py``): a viser web viewer updated
from a throttled background thread, per-step snapshot recording, and an
``OfflinePlayer`` that replays recorded sessions (optionally to mp4).

viser is an optional dependency: with it installed you get the live server
+ playback; without it, recording and replay still work, and the mp4
export renders its frames headlessly with matplotlib where that is
installed.  Snapshots are ``.npz`` files with the JAX package's keys and
step names (camera centers/orientations, track points and colours, stage
tag), so either package's player reads either's sessions.  Everything here
is host numpy: the mapper hands over host arrays.
"""

from __future__ import annotations

import glob
import os
import threading
import time
from typing import Optional

import numpy as np


def _viser():
    try:
        import viser
        return viser
    except ImportError:
        return None


class ReconstructionVisualizer:
    def __init__(self, serve: bool = False, save_data: bool = False,
                 save_dir: Optional[str] = None, update_interval: float = 0.5,
                 point_size: float = 0.02, log=print):
        self.save_data = save_data
        self.save_dir = save_dir
        self.update_interval = update_interval
        self.point_size = point_size
        self.log = log
        self._step_counter = 0
        self._lock = threading.Lock()
        self._latest = None
        self._server = None
        self._stop = threading.Event()

        if save_data and save_dir:
            session = time.strftime("session_%Y%m%d_%H%M%S")
            self.save_dir = os.path.join(save_dir, session)
            os.makedirs(self.save_dir, exist_ok=True)

        viser = _viser()
        if serve:
            if viser is None:
                log("viser is not installed; live GUI disabled "
                    "(recording still active)")
            else:
                self._server = viser.ViserServer()
                self._thread = threading.Thread(target=self._update_loop,
                                                daemon=True)
                self._thread.start()

    # ----------------------------------------------------------- recording

    def add_step(self, cameras, images, tracks, stage: str = "") -> None:
        """Snapshot current scene state (reference ``add_step``)."""
        reg = images.registered
        data = {
            "stage": stage,
            "centers": images.centers()[reg],
            "qvec": images.qvec[reg],
            "points": tracks.xyz[: tracks.num_tracks].copy()
            if tracks.num_tracks else np.zeros((0, 3)),
            "colors": tracks.color[: tracks.num_tracks].copy()
            if tracks.num_tracks else np.zeros((0, 3), np.uint8),
        }
        with self._lock:
            self._latest = data
        if self.save_data and self.save_dir:
            path = os.path.join(self.save_dir,
                                f"step_{self._step_counter:04d}.npz")
            np.savez_compressed(path, **data)
        self._step_counter += 1

    # --------------------------------------------------------- live server

    def _update_visualization(self, data) -> None:
        self._server.scene.add_point_cloud(
            "/points", points=data["points"].astype(np.float32),
            colors=data["colors"].astype(np.uint8)
            if len(data["colors"]) else np.zeros((0, 3), np.uint8),
            point_size=self.point_size)
        for i, (c, q) in enumerate(zip(data["centers"], data["qvec"])):
            wxyz = np.array([q[3], q[0], q[1], q[2]])
            self._server.scene.add_camera_frustum(
                f"/cams/{i}", fov=1.0, aspect=4 / 3, scale=0.1,
                wxyz=wxyz, position=c)

    def _update_loop(self) -> None:
        shown = None
        while not self._stop.is_set():
            with self._lock:
                data = self._latest
            if data is not None and data is not shown:
                try:
                    self._update_visualization(data)
                    shown = data
                except Exception as e:  # viser hiccups shouldn't kill the run
                    self.log(f"visualizer update failed: {e}")
            time.sleep(self.update_interval)

    def block(self) -> None:
        if self._server is None:
            return
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            self._stop.set()


class OfflinePlayer:
    """Replay a recorded session (reference ``OfflinePlayer``)."""

    def __init__(self, record_path: str, reconstruction_path: str = None,
                 log=print):
        self.log = log
        self.steps = sorted(glob.glob(os.path.join(record_path, "step_*.npz")))
        if not self.steps:
            raise FileNotFoundError(f"no recorded steps under {record_path}")
        # recolor from the final reconstruction if given
        self.final_colors = None
        if reconstruction_path and os.path.exists(reconstruction_path):
            from instantsfm_tpu_torch.io import colmap_model as cmio
            _, _, pts = cmio.read_model(reconstruction_path)
            if pts:
                self.final_colors = np.stack(
                    [p.rgb for p in sorted(pts.values(), key=lambda p: p.id)])

    def load_step(self, i: int) -> dict:
        z = np.load(self.steps[i], allow_pickle=True)
        return {k: z[k] for k in z.files}

    def __len__(self):
        return len(self.steps)

    def export_video(self, out_path: str, fps: int = 10,
                     figsize=(8, 6)) -> str:
        """Headless mp4 export of the recorded steps (matplotlib scatter;
        raises ``ImportError`` naming matplotlib where it is missing).
        Without imageio the frames go to an ``.npz`` beside ``out_path``."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        frames = []
        for i in range(len(self.steps)):
            d = self.load_step(i)
            fig = plt.figure(figsize=figsize)
            ax = fig.add_subplot(projection="3d")
            pts = d["points"]
            if len(pts):
                cols = (self.final_colors[: len(pts)] / 255.0
                        if self.final_colors is not None
                        and len(self.final_colors) >= len(pts)
                        else "steelblue")
                ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5, c=cols)
            c = d["centers"]
            if len(c):
                ax.scatter(c[:, 0], c[:, 1], c[:, 2], s=12, c="red", marker="^")
            ax.set_title(f"step {i}: {d.get('stage', '')}")
            fig.canvas.draw()
            w, h = fig.canvas.get_width_height()
            buf = np.frombuffer(fig.canvas.buffer_rgba(), np.uint8)
            frames.append(buf.reshape(h, w, 4)[..., :3].copy())
            plt.close(fig)
        try:
            import imageio.v2 as iio
            iio.mimwrite(out_path, frames, fps=fps)
        except Exception:
            out_path = out_path.rsplit(".", 1)[0] + ".npz"
            np.savez_compressed(out_path, frames=np.stack(frames))
        self.log(f"playback video written to {out_path}")
        return out_path

    def serve(self) -> None:
        viser = _viser()
        if viser is None:
            raise ImportError("viser is required for interactive playback; "
                              "use export_video() for headless replay")
        server = viser.ViserServer()
        idx = {"i": 0}
        slider = server.gui.add_slider("step", 0, len(self.steps) - 1, 1, 0)

        def show(i):
            d = self.load_step(i)
            server.scene.add_point_cloud(
                "/points", points=d["points"].astype(np.float32),
                colors=np.zeros((len(d["points"]), 3), np.uint8) + 128,
                point_size=0.02)

        @slider.on_update
        def _(_):
            show(int(slider.value))

        show(0)
        while True:
            time.sleep(1)
