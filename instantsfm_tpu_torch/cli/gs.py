"""``ins-gs`` equivalent: 3DGS training on a reconstructed scene.

Counterpart of ``instantsfm_tpu/cli/gs.py``:

    python -m instantsfm_tpu_torch.cli.gs --data_path SCENE [--device cuda|cpu]

SCENE holds ``images/`` and ``sparse/0``.  Runs train -> eval -> checkpoint
(or eval only from ``--ckpt``), then ``--export_ply`` writes
``point_cloud.ply`` from the final checkpoint and ``--render_traj KIND``
renders a trajectory (``videos/traj_KIND.mp4``, or ``.npz`` of the frames
where imageio's mp4 writer is not installed).  ``--distributed`` is not
ported and raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys

from instantsfm_tpu_torch.gs.ply import export_ply_from_checkpoint
from instantsfm_tpu_torch.gs.trainer import GSConfig, Runner


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", required=True,
                        help="scene dir with images/ and sparse/0")
    parser.add_argument("--result_dir", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--preset", default="default",
                        choices=["default", "mcmc"])
    parser.add_argument("--max_steps", type=int, default=30000)
    parser.add_argument("--data_factor", type=int, default=1)
    parser.add_argument("--depth_loss", action="store_true")
    parser.add_argument("--pose_opt", action="store_true")
    parser.add_argument("--app_opt", action="store_true")
    parser.add_argument("--use_bilateral_grid", action="store_true")
    parser.add_argument("--export_ply", action="store_true")
    parser.add_argument("--render_traj", default=None,
                        choices=[None, "interp", "ellipse", "spiral"])
    parser.add_argument("--ckpt", default=None, help="eval-only from ckpt")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--camera_model", default="pinhole",
                        choices=["pinhole", "ortho", "fisheye"])
    parser.add_argument("--patch_size", type=int, default=None)
    parser.add_argument("--steps_scaler", type=float, default=1.0)
    parser.add_argument("--visible_adam", action="store_true",
                        help="SelectiveAdam analog: update only visible gaussians")
    parser.add_argument("--compression", default=None, choices=["png"],
                        help="compress the model at eval steps")
    parser.add_argument("--distributed", action="store_true",
                        help="gaussian-sharded rendering over all devices")
    args = parser.parse_args(argv)

    cfg = GSConfig(
        data_dir=args.data_path,
        result_dir=args.result_dir or os.path.join(args.data_path, "gs_results"),
        data_factor=args.data_factor, max_steps=args.max_steps,
        strategy=args.preset, depth_loss=args.depth_loss,
        pose_opt=args.pose_opt, app_opt=args.app_opt,
        use_bilateral_grid=args.use_bilateral_grid,
        opacity_reg=0.01 if args.preset == "mcmc" else 0.0,
        scale_reg=0.01 if args.preset == "mcmc" else 0.0,
        batch_size=args.batch_size, distributed=args.distributed,
        visible_adam=args.visible_adam, compression=args.compression,
        camera_model=args.camera_model, patch_size=args.patch_size,
        steps_scaler=args.steps_scaler,
        eval_steps=(7000, args.max_steps), save_steps=(7000, args.max_steps))
    runner = Runner(cfg, device=args.device)

    if args.ckpt:
        step = runner.load_checkpoint(args.ckpt)
        runner.eval(step)
    else:
        runner.train()
        runner.eval(runner.cfg.max_steps)
        ckpt = runner.save_checkpoint(runner.cfg.max_steps)
        if args.export_ply:
            out = os.path.join(cfg.result_dir, "point_cloud.ply")
            export_ply_from_checkpoint(ckpt, out)
            print(f"PLY exported to {out}")
    if args.render_traj:
        runner.render_traj(args.render_traj)
    return 0


if __name__ == "__main__":
    sys.exit(main())
