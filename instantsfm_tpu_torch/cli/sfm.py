"""``ins-sfm`` equivalent: COLMAP database -> global SfM -> sparse model.

Counterpart of ``instantsfm_tpu/cli/sfm.py``:

    python -m instantsfm_tpu_torch.cli.sfm --data_path SCENE [--f32]
        [--export_txt] [--device cuda|cpu] [--record_recon]
        [--record_path DIR] [--enable_gui]

SCENE holds ``database.db`` (and optionally ``images/`` for point colors
and ``depth/``); the model is written to ``SCENE/sparse/0``.  The solve
runs in float32 on the card, and in float64 on the CPU unless ``--f32``
(as the JAX package's CLI: float64 only on its CPU backend).
``--record_recon`` saves a snapshot after global positioning and after
each BA round under ``DIR/session_<time>`` (default ``SCENE/record``;
replay with ``cli.vis``); ``--enable_gui`` serves them live where viser
is installed and blocks at the end.  Either makes BA run its per-round
loop, as in JAX.

Started as several processes (``ISFM_COORDINATOR`` /
``ISFM_NUM_PROCESSES`` / ``ISFM_PROCESS_ID``, or torchrun; see
``parallel/multihost.py``), every process runs the mapper, relative pose
shares its chunks and the LM solves shard their points over the ranks;
rank 0 alone writes the model and records (the JAX CLI writes it from
every process, and on a shared path those writes race).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--export_txt", action="store_true")
    parser.add_argument("--disable_depths", action="store_true")
    parser.add_argument("--enable_gui", action="store_true",
                        help="serve a live view of the reconstruction")
    parser.add_argument("--record_recon", action="store_true",
                        help="record per-step reconstruction snapshots")
    parser.add_argument("--record_path", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--f32", action="store_true",
                        help="solve in float32 (the default on the card; "
                             "the CPU's default is float64)")
    args = parser.parse_args(argv)

    from instantsfm_tpu_torch.config import Config
    from instantsfm_tpu_torch.io.colmap_db import read_colmap_database
    from instantsfm_tpu_torch.pipeline.data_reader import (
        read_data, read_depths_into_features)
    from instantsfm_tpu_torch.pipeline.mapper import solve_global_mapper
    from instantsfm_tpu_torch.pipeline.writer import write_reconstruction
    from instantsfm_tpu_torch.utils.device import resolve_device

    from instantsfm_tpu_torch.parallel import multihost
    if multihost.initialize(device=args.device):
        print(f"[distributed] process {multihost.process_index()}"
              f"/{multihost.process_count()}")
    device = resolve_device(args.device)
    use_f64 = device.type == "cpu" and not args.f32
    dtype = torch.float64 if use_f64 else torch.float32
    path_info = read_data(args.data_path)
    if not path_info.database_exists:
        print(f"No database.db found under {args.data_path}", file=sys.stderr)
        return 1

    view_graph, cameras, images, feature_name = read_colmap_database(
        path_info.database_path)
    print(f"Read {images.num_images} images, {view_graph.num_pairs} pairs "
          f"({feature_name} features); device={device} dtype={dtype}")

    depths_available = False
    if path_info.depth_path and not args.disable_depths:
        depths_available = read_depths_into_features(
            path_info.depth_path, cameras, images)

    visualizer = None
    if (args.enable_gui or args.record_recon) \
            and multihost.process_index() == 0:
        from instantsfm_tpu_torch.vis.visualizer import \
            ReconstructionVisualizer
        visualizer = ReconstructionVisualizer(
            serve=args.enable_gui, save_data=args.record_recon,
            save_dir=args.record_path or path_info.record_path)

    t0 = time.time()
    cameras, images, tracks, _ = solve_global_mapper(
        view_graph, cameras, images, Config(feature_name),
        depths_available=depths_available, visualizer=visualizer,
        dtype=dtype, device=device)
    print(f"Reconstruction done in {time.time() - t0:.2f} seconds")

    if multihost.process_index() == 0:
        write_reconstruction(path_info.output_path, cameras, images, tracks,
                             path_info.image_path, export_txt=args.export_txt)
        print(f"Reconstruction written to {path_info.output_path}")
    if visualizer is not None and args.enable_gui:
        visualizer.block()
    return 0


if __name__ == "__main__":
    sys.exit(main())
