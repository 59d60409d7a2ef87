"""3DGS training loop (reference ``vis/gsplat_trainer.py`` Runner).

Counterpart of ``instantsfm_tpu/gs/trainer.py``.  Losses, cadences and
knobs mirror the reference defaults: loss = (1-λ)·L1 + λ·(1-SSIM) with
λ = 0.2, optional disparity-L1 depth supervision from SfM points, optional
opacity/scale regularizers, bilateral-grid TV; densification by the
fixed-capacity DefaultStrategy or the MCMC relocation; per-group Adam,
optionally selective (``visible_adam``); pose and appearance modules with
their own Adams; PSNR/SSIM (and LPIPS where its weights are present) eval
at step milestones, PNG compression there; npz checkpoints; trajectory
renders.  A batch of views is a loop over views whose losses are averaged
before one backward pass.

``distributed`` (gaussian-sharded rendering over several devices) is not
ported: it raises ``NotImplementedError`` naming its ROADMAP item (queue 1
item 6).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from instantsfm_tpu_torch.gs import (bilateral, camera_opt, data as data_mod,
                                     optim as optim_mod,
                                     rasterize as raster_mod,
                                     splats as splats_mod, ssim as ssim_mod,
                                     strategy as strat_mod)
from instantsfm_tpu_torch.gs.splats import FIELDS, FLOAT_FIELDS
from instantsfm_tpu_torch.utils.device import full_f32, resolve_device
from instantsfm_tpu_torch.utils.scalars import ScalarLogger


@dataclass
class GSConfig:
    # mirrors the reference Config (gsplat_trainer.py:56-198), key fields
    data_dir: str = ""
    result_dir: str = "results"
    data_factor: int = 1
    image_folder_name: str = "images"
    test_every: int = 8
    max_steps: int = 30000
    steps_scaler: float = 1.0          # scales every step count/milestone
    eval_steps: tuple = (7000, 30000)
    save_steps: tuple = (7000, 30000)
    batch_size: int = 1
    patch_size: Optional[int] = None   # random-crop training patches
    global_scale: float = 1.0
    normalize_world_space: bool = True
    camera_model: str = "pinhole"      # "pinhole" | "ortho" | "fisheye"
    init_type: str = "sfm"             # "sfm" | "random"
    init_num_pts: int = 100_000
    init_extent: float = 3.0
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    init_opa: float = 0.1
    init_scale: float = 1.0
    ssim_lambda: float = 0.2
    near_plane: float = 0.01
    far_plane: float = 1e10
    strategy: str = "default"          # "default" | "mcmc"
    capacity_mult: float = 4.0         # pool = mult * init points
    max_capacity: int = 1_000_000
    opacity_reg: float = 0.0
    scale_reg: float = 0.0
    pose_opt: bool = False
    pose_opt_lr: float = 1e-5
    pose_opt_reg: float = 1e-6
    pose_noise: float = 0.0
    app_opt: bool = False
    app_embed_dim: int = 16
    app_opt_lr: float = 1e-3
    app_opt_reg: float = 1e-6
    use_bilateral_grid: bool = False
    bilateral_grid_shape: tuple = (16, 16, 8)
    bilateral_grid_lr: float = 2e-3
    depth_loss: bool = False
    depth_lambda: float = 1e-2
    tile_capacity: int = 512
    tiles_per_gauss: int = 16
    random_bkgd: bool = False
    lpips_net: str = "alex"            # LPIPS where its weights are present
    distributed: bool = False          # gaussian-sharded multi-device rendering
    tb_every: int = 100                # scalar-log cadence (ref tb_every)
    tb_save_image: bool = False        # also dump train renders
    visible_adam: bool = False         # SelectiveAdam analog
    compression: Optional[str] = None  # "png" -> compress at eval steps


# option -> the JAX module it needs, still to port (ROADMAP queue 1 item 6)
NOT_PORTED = {"distributed": "gs/distributed.py"}
MAX_DEPTH_PTS = 2048       # depth-supervision points per view, padded


def not_ported(what: str, module: str):
    return NotImplementedError(
        f"{what} is not ported to instantsfm_tpu_torch yet: it needs "
        f"{module} (ROADMAP.md queue 1 item 6)")


def _write_video(path_stem: str, frames, fps: int) -> str:
    """An mp4 where imageio and its ffmpeg plugin import, else an npz of
    the frames [F, H, W, 3] uint8; returns the path written."""
    try:
        import imageio.v2 as iio
        import imageio_ffmpeg  # noqa: F401  (imageio's mp4 writer)
    except ImportError:
        np.savez(path_stem + ".npz", frames=np.stack(frames))
        return path_stem + ".npz"
    iio.mimwrite(path_stem + ".mp4", frames, fps=fps)
    return path_stem + ".mp4"


class Runner:
    def __init__(self, cfg: GSConfig, log=print, device="cuda"):
        for name, module in NOT_PORTED.items():
            if getattr(cfg, name):
                raise not_ported(f"GSConfig.{name}", module)
        if cfg.strategy not in ("default", "mcmc"):
            raise ValueError(f"unknown strategy {cfg.strategy!r}")
        if cfg.compression not in (None, "png"):
            raise ValueError(f"unknown compression {cfg.compression!r}")
        if cfg.steps_scaler != 1.0:
            # reference steps_scaler: scale every schedule milestone
            sc = cfg.steps_scaler
            cfg = dataclasses.replace(
                cfg, steps_scaler=1.0,
                max_steps=int(cfg.max_steps * sc),
                eval_steps=tuple(int(s * sc) for s in cfg.eval_steps),
                save_steps=tuple(int(s * sc) for s in cfg.save_steps),
                sh_degree_interval=int(cfg.sh_degree_interval * sc))
        self.cfg = cfg
        self.log = log
        self.device = resolve_device(device)
        os.makedirs(cfg.result_dir, exist_ok=True)
        self.parser = data_mod.Parser(cfg.data_dir, factor=cfg.data_factor,
                                      test_every=cfg.test_every,
                                      normalize=cfg.normalize_world_space,
                                      image_folder_name=cfg.image_folder_name)
        self.trainset = data_mod.Dataset(self.parser, "train",
                                         load_depths=cfg.depth_loss)
        self.valset = data_mod.Dataset(self.parser, "val")
        self.scene_scale = self.parser.scene_scale * cfg.global_scale

        if cfg.pose_noise > 0:
            # perturb training poses (reference gsplat_trainer pose_noise)
            from scipy.spatial.transform import Rotation
            prng = np.random.default_rng(7)
            c2w = self.parser.camtoworlds.copy()
            dR = Rotation.from_rotvec(
                prng.standard_normal((len(c2w), 3)) * cfg.pose_noise)
            c2w[:, :3, :3] = np.einsum("nij,njk->nik", dR.as_matrix(),
                                       c2w[:, :3, :3])
            c2w[:, :3, 3] += prng.standard_normal((len(c2w), 3)) * cfg.pose_noise
            self.parser.camtoworlds = c2w

        if cfg.init_type == "random" or len(self.parser.points) == 0:
            # reference init_type="random": uniform cube scaled to the scene
            prng = np.random.default_rng(11)
            ext = cfg.init_extent * self.scene_scale
            pts = prng.uniform(-ext, ext, (cfg.init_num_pts, 3))
            rgb = prng.uniform(0, 1, (cfg.init_num_pts, 3))
        else:
            pts = self.parser.points
            rgb = self.parser.points_rgb.astype(np.float32) / 255.0
        capacity = min(int(len(pts) * cfg.capacity_mult) + 1024,
                       cfg.max_capacity)
        self.splats = splats_mod.init_splats(
            pts, rgb, capacity, sh_degree=cfg.sh_degree,
            init_opacity=cfg.init_opa, init_scale_mult=cfg.init_scale,
            device=self.device)
        for f in FLOAT_FIELDS:
            getattr(self.splats, f).requires_grad_(True)
        self.optimizer = splats_mod.make_optimizer(
            splats_mod.float_params(self.splats), self.scene_scale,
            max_steps=cfg.max_steps,
            batch_scale=float(np.sqrt(cfg.batch_size)))
        self.n_updates = 0
        self.strategy_state = strat_mod.init_state(capacity, self.device)
        self.strategy_cfg = strat_mod.StrategyConfig()
        self.mcmc_cfg = strat_mod.MCMCConfig()
        self.generator = torch.Generator(device=self.device).manual_seed(42)

        # per-image modules, each with its own Adam (optax's
        # chain(add_decayed_weights(reg), adam(lr)) is Adam's weight_decay)
        n_imgs = len(self.parser.image_names)
        self.aux, self.aux_opt = {}, {}
        if cfg.pose_opt:
            self.aux["pose"] = camera_opt.CameraOptModule(n_imgs,
                                                          device=self.device)
            self.aux_opt["pose"] = torch.optim.Adam(
                self.aux["pose"].parameters(), lr=cfg.pose_opt_lr,
                weight_decay=cfg.pose_opt_reg)
        if cfg.app_opt:
            self.aux["app"] = camera_opt.AppearanceOptModule(
                n_imgs, embed_dim=cfg.app_embed_dim, sh_degree=cfg.sh_degree,
                generator=torch.Generator().manual_seed(0), device=self.device)
            self.aux_opt["app"] = torch.optim.Adam(
                self.aux["app"].parameters(), lr=cfg.app_opt_lr,
                weight_decay=cfg.app_opt_reg)
        if cfg.use_bilateral_grid:
            gw, gh, gg = cfg.bilateral_grid_shape
            self.aux["bilgrid"] = bilateral.BilateralGrid(
                n_imgs, grid_w=gw, grid_h=gh, grid_g=gg, device=self.device)
            self.aux_opt["bilgrid"] = torch.optim.Adam(
                self.aux["bilgrid"].parameters(), lr=cfg.bilateral_grid_lr)

        self.stats = {}
        self.refines = []       # one record per refine: step, counts
        self.relocations = []   # one record per MCMC relocation: step, moved
        self.step_s = []        # host seconds of each step after data loading
        self.writer = ScalarLogger(os.path.join(cfg.result_dir, "tb"))

    # ------------------------------------------------------------ rendering

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _render(self, splats, camtoworld, K, width, height, sh_degree,
                image_id, offset, bkgd):
        cfg = self.cfg
        if "pose" in self.aux:
            camtoworld = self.aux["pose"](camtoworld, image_id)
        viewmat = torch.linalg.inv(camtoworld)
        opac = torch.sigmoid(splats.opacities) * splats.alive
        return raster_mod.rasterize(
            splats.means, splats.quats, torch.exp(splats.scales), opac,
            torch.cat([splats.sh0, splats.shN], dim=1), viewmat, K,
            width=width, height=height, sh_degree=sh_degree,
            tiles_per_gauss=cfg.tiles_per_gauss,
            tile_capacity=cfg.tile_capacity, background=bkgd,
            means2d_offset=offset, camera_model=cfg.camera_model)

    def _loss(self, splats, view, offset, sh_degree):
        cfg = self.cfg
        H, W = view["image"].shape[:2]
        if cfg.random_bkgd:
            bkgd = torch.rand(3, generator=self.generator, device=self.device)
        else:
            bkgd = torch.zeros(3, device=self.device)
        out = self._render(splats, view["camtoworld"], view["K"], W, H,
                           sh_degree, view["image_id"], offset, bkgd)
        rgb = out.rgb
        if "bilgrid" in self.aux:
            rgb = self.aux["bilgrid"](view["image_id"], rgb)
        gt = view["image"]
        l1 = torch.mean(torch.abs(rgb - gt))
        s = ssim_mod.ssim(rgb, gt)
        loss = (1 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * (1 - s)
        if cfg.depth_loss and "points" in view:
            loss = loss + cfg.depth_lambda * depth_loss(
                out, view["points"], view["depths"], view["points_valid"])
        if cfg.opacity_reg > 0:
            loss = loss + cfg.opacity_reg * torch.mean(
                torch.abs(torch.sigmoid(splats.opacities)) * splats.alive)
        if cfg.scale_reg > 0:
            loss = loss + cfg.scale_reg * torch.mean(
                torch.abs(torch.exp(splats.scales)) * splats.alive[:, None])
        if "bilgrid" in self.aux:
            loss = loss + 10.0 * bilateral.total_variation_loss(
                self.aux["bilgrid"].grids)
        return loss, (out, l1, s)

    # ------------------------------------------------------------- training

    def _train_step(self, views, sh_degree: int):
        """One step over a batch of views: their losses are averaged, one
        backward pass, one Adam update.  Returns (loss, l1, ssim, probe
        gradient [N, 2], radii [N] max over views, seen [N])."""
        splats = self.splats
        offset = torch.zeros((splats.means.shape[0], 2), device=self.device,
                             dtype=splats.means.dtype, requires_grad=True)
        results = [self._loss(splats, v, offset, sh_degree) for v in views]
        loss = torch.stack([r[0] for r in results]).mean()
        optimizers = [self.optimizer, *self.aux_opt.values()]
        for opt in optimizers:
            opt.zero_grad(set_to_none=True)
        loss.backward()
        for opt in optimizers:
            for group in opt.param_groups:
                for p in group["params"]:
                    # optax steps every parameter each update, with a zero
                    # gradient where the loss does not reach it (the
                    # appearance module's, which the loss never calls)
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
        outs = [r[1][0] for r in results]
        radii = torch.stack([o.radii for o in outs]).amax(0)
        seen = torch.stack([o.valid for o in outs]).any(0)
        splats_mod.set_lr(self.optimizer, self.n_updates)
        if self.cfg.visible_adam:
            optim_mod.selective_step(self.optimizer, seen)
        else:
            self.optimizer.step()
        for opt in self.aux_opt.values():
            opt.step()
        self.n_updates += 1
        l1 = torch.stack([r[1][1] for r in results]).mean()
        s = torch.stack([r[1][2] for r in results]).mean()
        return loss.detach(), l1.detach(), s.detach(), offset.grad, radii, seen

    def _views(self, rng):
        cfg = self.cfg
        views = [self.trainset[int(rng.integers(0, len(self.trainset)))]
                 for _ in range(cfg.batch_size)]
        if cfg.patch_size:
            # random-crop training patches (reference patch_size): crop the
            # image and shift the principal point accordingly
            ps = cfg.patch_size
            for v in views:
                Hv, Wv = v["image"].shape[:2]
                x0 = int(rng.integers(0, max(Wv - ps, 0) + 1))
                y0 = int(rng.integers(0, max(Hv - ps, 0) + 1))
                v["image"] = v["image"][y0:y0 + ps, x0:x0 + ps]
                K = np.array(v["K"], np.float32)
                K[0, 2] -= x0
                K[1, 2] -= y0
                v["K"] = K
        return [self._prepare(v) for v in views]

    def _prepare(self, v):
        """A dataset item -> the tensors ``_loss`` reads; with the depth
        loss, the view's SfM points padded to MAX_DEPTH_PTS with a mask."""
        out = {"image": self._tensor(v["image"]), "K": self._tensor(v["K"]),
               "camtoworld": self._tensor(v["camtoworld"]),
               "image_id": v["image_id"]}
        if self.cfg.depth_loss:
            pts = np.zeros((MAX_DEPTH_PTS, 2), np.float32)
            dep = np.zeros(MAX_DEPTH_PTS, np.float32)
            n = min(len(v.get("points", [])), MAX_DEPTH_PTS)
            if n:
                pts[:n] = v["points"][:n]
                dep[:n] = v["depths"][:n]
            out["points"], out["depths"] = self._tensor(pts), self._tensor(dep)
            out["points_valid"] = torch.arange(MAX_DEPTH_PTS,
                                               device=self.device) < n
        return out

    def train(self):
        cfg = self.cfg
        rng = np.random.default_rng(0)
        t_start = time.time()
        losses = []
        for step in range(cfg.max_steps):
            views = self._views(rng)
            t0 = time.perf_counter()
            sh_degree = min(step // cfg.sh_degree_interval, cfg.sh_degree)
            loss, l1, s, g_offset, radii, valid = self._train_step(
                views, sh_degree)
            losses.append(float(loss))

            if cfg.strategy == "default":
                self._default_strategy(step, g_offset, radii, valid)
            else:
                self._mcmc_strategy(step)
            self.step_s.append(time.perf_counter() - t0)

            if step % 100 == 0:
                self.log(f"step {step}: loss {float(loss):.4f} "
                         f"l1 {float(l1):.4f} ssim {float(s):.4f}")
            if cfg.tb_every > 0 and step % cfg.tb_every == 0:
                self._log_scalars(step, loss, l1, s, views, sh_degree)
            if step + 1 in cfg.eval_steps:
                self.eval(step + 1)
                if cfg.compression == "png":
                    from instantsfm_tpu_torch.gs import compression
                    cdir = os.path.join(cfg.result_dir, "compression",
                                        f"step{step + 1}")
                    compression.compress_splats(self.splats, cdir)
                    self.log(f"compressed model written to {cdir}")
            if step + 1 in cfg.save_steps:
                self.save_checkpoint(step + 1)
        self.log(f"training done in {time.time() - t_start:.1f}s")
        self.writer.flush()
        return losses

    def _default_strategy(self, step, g_offset, radii, valid):
        """Densification cadence of the DefaultStrategy."""
        sc = self.strategy_cfg
        self.strategy_state = strat_mod.accumulate(
            self.strategy_state, g_offset, radii, valid)
        if (sc.refine_start_iter <= step < sc.refine_stop_iter
                and step % sc.refine_every == 0 and step > 0):
            alive_before = int(self.splats.alive.sum())
            self.splats, self.strategy_state, n_grow, n_prune = \
                strat_mod.refine(self.splats, self.optimizer,
                                 self.strategy_state, self.scene_scale,
                                 sc, prune_too_big=step > sc.reset_every,
                                 generator=self.generator)
            alive = int(self.splats.alive.sum())
            self.refines.append(dict(step=step, grown=n_grow, pruned=n_prune,
                                     alive_before=alive_before,
                                     alive_after=alive))
            if step % 500 == 0:
                self.log(f"step {step}: +{n_grow} -{n_prune} splats, "
                         f"alive={alive}")
        if step % sc.reset_every == 0 and 0 < step < sc.refine_stop_iter:
            strat_mod.reset_opacity(self.splats, self.optimizer)

    def _mcmc_strategy(self, step):
        """MCMC: relocate the low-opacity gaussians on the refine cadence,
        then position noise every step."""
        mc = self.mcmc_cfg
        if (mc.refine_start_iter <= step < mc.refine_stop_iter
                and step % mc.refine_every == 0 and step > 0):
            moved = strat_mod.mcmc_relocate(self.splats, self.optimizer,
                                            mc.min_opacity, self.generator)
            self.relocations.append(dict(step=step, moved=moved))
        strat_mod.mcmc_noise(self.splats, 1.6e-4 * self.scene_scale,
                             mc.noise_lr, self.generator)

    def _log_scalars(self, step, loss, l1, s, views, sh_degree):
        """Scalar stream (reference tb cadence, gsplat_trainer.py:708-723)."""
        w = self.writer
        w.add_scalar("train/loss", float(loss), step)
        w.add_scalar("train/l1loss", float(l1), step)
        w.add_scalar("train/ssimloss", float(s), step)
        w.add_scalar("train/num_GS", int(self.splats.alive.sum()), step)
        if self.device.type == "cuda":
            w.add_scalar("train/mem", torch.cuda.memory_allocated(self.device)
                         / 1024 ** 3, step)
        if self.cfg.tb_save_image:
            v = views[0]
            H, W = v["image"].shape[:2]
            with torch.no_grad():
                out = self._render(self.splats, v["camtoworld"], v["K"], W, H,
                                   sh_degree, v["image_id"], None,
                                   torch.zeros(3, device=self.device))
            canvas = torch.cat([v["image"], torch.clamp(out.rgb, 0, 1)], 1)
            w.add_image("train/render", canvas.cpu().numpy(), step)
        w.flush()

    # ----------------------------------------------------------- eval / io

    @torch.no_grad()
    def eval(self, step: int):
        """PSNR and SSIM over the val split, and LPIPS where its weights
        file is present (``lpips.default_weights_path``); the val views are
        pose-adjusted by their image ids, as in JAX."""
        from instantsfm_tpu_torch import convert
        from instantsfm_tpu_torch.gs import lpips as lpips_mod

        cfg = self.cfg
        w = lpips_mod.try_load_default()
        net = None if w is None else convert.lpips_from_numpy(w, self.device)
        psnrs, ssims, lpipss = [], [], []
        for i in range(len(self.valset)):
            b = self.valset[i]
            H, W = b["image"].shape[:2]
            out = self._render(self.splats, self._tensor(b["camtoworld"]),
                               self._tensor(b["K"]), W, H, cfg.sh_degree,
                               b["image_id"], None,
                               torch.zeros(3, device=self.device))
            rgb = torch.clamp(out.rgb, 0, 1)
            gt = self._tensor(b["image"])
            psnrs.append(float(ssim_mod.psnr(rgb, gt)))
            ssims.append(float(ssim_mod.ssim(rgb, gt)))
            if net is not None:
                with full_f32():
                    lpipss.append(float(net(rgb, gt)))
        stats = {"psnr": float(np.mean(psnrs)) if psnrs else 0.0,
                 "ssim": float(np.mean(ssims)) if ssims else 0.0,
                 "num_GS": int(self.splats.alive.sum())}
        if lpipss:
            stats["lpips"] = float(np.mean(lpipss))
        self.stats[step] = stats
        self.log(f"eval @ {step}: {stats}")
        for k, v in stats.items():
            self.writer.add_scalar(f"val/{k}", v, step)
        self.writer.flush()
        os.makedirs(os.path.join(cfg.result_dir, "stats"), exist_ok=True)
        with open(os.path.join(cfg.result_dir, "stats", f"val_{step}.json"),
                  "w") as f:
            json.dump(stats, f)
        return stats

    def save_checkpoint(self, step: int):
        ckpt_dir = os.path.join(self.cfg.result_dir, "ckpts")
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"ckpt_{step}.npz")
        np.savez(path, step=step,
                 **{f: getattr(self.splats, f).detach().cpu().numpy()
                    for f in FIELDS})
        self.log(f"checkpoint saved: {path}")
        return path

    @torch.no_grad()
    def load_checkpoint(self, path: str):
        """Copy a checkpoint's fields into the pool (same capacity), in
        place, so the optimizer keeps its parameters."""
        z = np.load(path)
        for f in FIELDS:
            dst = getattr(self.splats, f)
            if tuple(z[f].shape) != tuple(dst.shape):
                raise ValueError(f"checkpoint {f} has shape {z[f].shape}, "
                                 f"the pool {tuple(dst.shape)}")
            dst.copy_(torch.as_tensor(z[f]))
        return int(z["step"])

    @torch.no_grad()
    def render_traj(self, kind: str = "interp", n_frames: int = 60,
                    fps: int = 30) -> str:
        """Render ``n_frames`` along an interpolated, ellipse or spiral path
        through the training cameras (first camera's K and size, image 0's
        pose delta, as in JAX); writes ``videos/traj_{kind}.mp4``, or an npz
        of the frames where imageio's mp4 writer is not installed."""
        from instantsfm_tpu_torch.gs import traj as traj_mod

        c2w = self.parser.camtoworlds
        if kind == "interp":
            sub = c2w[::max(len(c2w) // 10, 1)]
            path = traj_mod.generate_interpolated_path(
                sub, n_interp=max(n_frames // max(len(sub) - 1, 1), 1))
        elif kind == "ellipse":
            path = traj_mod.generate_ellipse_path(c2w, n_frames)
        else:
            path = traj_mod.generate_spiral_path(c2w, n_frames)
        K = self._tensor(self.parser.Ks[0])
        W, H = int(self.parser.widths[0]), int(self.parser.heights[0])
        frames = []
        for M in path[:n_frames]:
            out = self._render(self.splats, self._tensor(M), K, W, H,
                               self.cfg.sh_degree, 0, None,
                               torch.zeros(3, device=self.device))
            frames.append((torch.clamp(out.rgb, 0, 1) * 255).to(torch.uint8)
                          .cpu().numpy())
        video_dir = os.path.join(self.cfg.result_dir, "videos")
        os.makedirs(video_dir, exist_ok=True)
        out_path = _write_video(os.path.join(video_dir, f"traj_{kind}"),
                                frames, fps)
        self.log(f"trajectory render saved: {out_path}")
        return out_path


def depth_loss(out, points, depths, points_valid):
    """Disparity L1 at the SfM points of a view: points [M, 2] pixel
    coordinates (truncated to integers, then clipped, as JAX's
    ``astype(int32)``), depths [M], points_valid [M]; a point counts where
    its rendered alpha exceeds 0.5.  The gradient reaches the compositing
    kernel's alpha and depth rows."""
    H, W = out.alpha.shape
    px = torch.clamp(points[:, 0].to(torch.int64), 0, W - 1)
    py = torch.clamp(points[:, 1].to(torch.int64), 0, H - 1)
    flat = py * W + px
    acc = torch.index_select(out.alpha.reshape(-1), 0, flat)
    d = torch.index_select(out.depth.reshape(-1), 0, flat) \
        / torch.clamp(acc, min=1e-6)
    valid = points_valid & (depths > 1e-6) & (acc > 0.5)
    disp_err = torch.abs(1.0 / torch.clamp(d, min=1e-6)
                         - 1.0 / torch.clamp(depths, min=1e-6))
    disp_err = torch.where(valid, disp_err, torch.zeros_like(disp_err))
    return torch.sum(disp_err) / torch.clamp(valid.sum(), min=1)
