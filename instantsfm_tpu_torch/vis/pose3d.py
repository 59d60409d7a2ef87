"""Standalone sparse-model viewer (reference ``vis/pose3d.py``: viser browser
for COLMAP models).

Counterpart of ``instantsfm_tpu/vis/pose3d.py``: viser-gated; the headless
fallback exports the same HTML view as the demo.  Camera centres are
computed in torch on ``--device`` (the card unless ``--device cpu``)."""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def serve(sparse_dir: str, point_size: float = 0.02, device="cuda"):
    try:
        import viser
    except ImportError as e:
        raise ImportError("viser is required for the interactive viewer; "
                          "use --export_html for headless viewing") from e
    from instantsfm_tpu_torch.io import colmap_model as cmio
    from instantsfm_tpu_torch.math import lie
    from instantsfm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cams, imgs, pts = cmio.read_model(sparse_dir)
    server = viser.ViserServer()
    xyz = np.stack([p.xyz for p in pts.values()]) if pts else np.zeros((0, 3))
    rgb = np.stack([p.rgb for p in pts.values()]).astype(np.uint8) \
        if pts else np.zeros((0, 3), np.uint8)
    server.scene.add_point_cloud("/points", points=xyz.astype(np.float32),
                                 colors=rgb, point_size=point_size)
    for im in imgs.values():
        w, x, y, z = im.qvec_wxyz
        c = lie.camera_center(
            torch.tensor([x, y, z, w], dtype=torch.float64, device=dev),
            torch.as_tensor(np.asarray(im.tvec, np.float64), device=dev))
        server.scene.add_camera_frustum(
            f"/cams/{im.id}", fov=1.0, aspect=4 / 3, scale=0.1,
            wxyz=np.array([w, x, y, z]), position=c.cpu().numpy())
    while True:
        time.sleep(1)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--sparse_dir", required=True)
    parser.add_argument("--export_html", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.export_html:
        from instantsfm_tpu_torch.cli.demo import write_html_view
        out = write_html_view(args.sparse_dir, args.export_html,
                              device=args.device)
        print(f"view written to {out}")
        return 0
    serve(args.sparse_dir, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
