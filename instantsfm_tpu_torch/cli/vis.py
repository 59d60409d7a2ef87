"""``ins-vis`` equivalent: replay a recorded reconstruction session
(reference ``scripts/vis_recon.py``).

Counterpart of ``instantsfm_tpu/cli/vis.py``:

    python -m instantsfm_tpu_torch.cli.vis --data_path SCENE
        [--session DIR] [--export_video OUT.mp4] [--fps N]

replays the newest ``SCENE/record/session_*`` (recorded by ``cli.sfm
--record_recon``), recoloured from ``SCENE/sparse/0`` where it exists."""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--session", default=None,
                        help="specific session dir (default: latest)")
    parser.add_argument("--export_video", default=None,
                        help="write an mp4 instead of serving")
    parser.add_argument("--fps", type=int, default=10)
    args = parser.parse_args(argv)

    from instantsfm_tpu_torch.vis.visualizer import OfflinePlayer

    record_root = os.path.join(args.data_path, "record")
    if args.session:
        session = args.session
    else:
        sessions = sorted(glob.glob(os.path.join(record_root, "session_*")))
        if not sessions:
            print(f"no recorded sessions under {record_root}", file=sys.stderr)
            return 1
        session = sessions[-1]
    sparse = os.path.join(args.data_path, "sparse", "0")
    player = OfflinePlayer(session, sparse if os.path.exists(sparse) else None)
    print(f"loaded {len(player)} steps from {session}")
    if args.export_video:
        player.export_video(args.export_video, fps=args.fps)
    else:
        player.serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
