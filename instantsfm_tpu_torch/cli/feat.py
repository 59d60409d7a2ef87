"""``ins-feat`` equivalent: images -> COLMAP database.

Counterpart of ``instantsfm_tpu/cli/feat.py``:

    python -m instantsfm_tpu_torch.cli.feat --data_path SCENE
        [--max_keypoints N] [--match_ratio R] [--sequential_overlap N]
        [--max_image_size N] [--feature_name NAME] [--device cuda|cpu]

NAME is ``sift_tpu`` (default), ``superpoint`` (or ``superpoint_tpu``),
``superpoint+lightglue``, ``disk``, ``disk+lightglue``, ``dedode`` or
``colmap``, as JAX's CLI takes; the learned ones need their converted
weights (``features/handler.py``).

SCENE holds ``images/`` (or ``color/``); the database is written to
``SCENE/database.db``, and an existing database is left as it is.
Extraction and matching run on ``--device`` (the card by default).
Started as several processes (``parallel/multihost.py``), each extracts
and matches a strided slice, and rank 0 writes the database.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--feature_name", default="sift_tpu")
    parser.add_argument("--max_image_size", type=int, default=1600)
    parser.add_argument("--max_keypoints", type=int, default=4096)
    parser.add_argument("--sequential_overlap", type=int, default=0,
                        help=">0 switches exhaustive matching to sequential")
    parser.add_argument("--match_ratio", type=float, default=None,
                        help="Lowe ratio (default 0.85 SIFT, 0.95 SuperPoint "
                             "and DISK, 0.92 DeDoDe)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from instantsfm_tpu_torch.config import Config
    from instantsfm_tpu_torch.features.handler import generate_database
    from instantsfm_tpu_torch.pipeline.data_reader import read_data
    from instantsfm_tpu_torch.utils.device import resolve_device

    from instantsfm_tpu_torch.parallel import multihost
    if multihost.initialize(device=args.device):
        print(f"[distributed] process {multihost.process_index()}"
              f"/{multihost.process_count()}")
    device = resolve_device(args.device)
    path_info = read_data(args.data_path)
    if path_info.database_exists:
        print(f"Database already exists at {path_info.database_path}; "
              "skipping")
        return 0
    if not path_info.image_path:
        print(f"No images/ or color/ folder under {args.data_path}",
              file=sys.stderr)
        return 1

    generate_database(path_info.image_path, path_info.database_path,
                      feature_name=args.feature_name, config=Config("colmap"),
                      max_image_size=args.max_image_size,
                      max_keypoints=args.max_keypoints,
                      match_ratio=args.match_ratio,
                      sequential_overlap=args.sequential_overlap,
                      device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
