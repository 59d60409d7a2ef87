"""Unit ``mapper_pass``: the whole mapper, database to written model.

Set-up draws the ring scene of the configuration from the seed, writes its
COLMAP database (plain ``sqlite3``) and runs one pass to build and warm
every kernel the pass uses.  A unit is one pass of the program's entry
points on that database: ``read_colmap_database``, ``solve_global_mapper``
in the configuration's precision, ``write_reconstruction`` into a directory
of its own.  The work is the images in the database.

Each pass is an answer, judged after the window in two parts.  The
written model is read back and scored against the scene's ground truth
(``yardstick.model``): every image registered, every rotation close.  And
the last round of bundle adjustment, the solve the written poses and points
come from, is held against the plain reference: a tap on the program's
``pipeline.ba.optimize`` keeps that round's start, observations and result
(references to the program's tensors; a clone of the start), and the
reference (``yardstick.ba_reference``) solves the same problem from the
same start to convergence in float64.  The round's start is the program's
own state, so the reference follows the program from there; the start is
judged by the score against the truth.  The control puts the reference in
that round's place in float32 with TF32 products, for as many steps as the
program took.
"""

from __future__ import annotations

import os
import time

import torch
from torch.profiler import record_function

from yardstick import ba_reference as ref
from yardstick import model as model_mod
from yardstick import ring

WORK = "images"


class Unit:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 workdir: str, log, control: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.workdir, self.log = device, workdir, log
        self.control = control
        self.answers = []
        self._untap = None
        self._round = None

    def setup(self) -> None:
        from instantsfm_tpu_torch.config import Config
        from instantsfm_tpu_torch.io.colmap_db import read_colmap_database
        from instantsfm_tpu_torch.pipeline.mapper import solve_global_mapper
        from instantsfm_tpu_torch.pipeline.writer import write_reconstruction
        from instantsfm_tpu_torch.solve import schur_wchain
        from instantsfm_tpu_torch.utils import debug
        self._read, self._solve = read_colmap_database, solve_global_mapper
        self._write, self._Config = write_reconstruction, Config
        self._k1, self._debug = schur_wchain.schur_wchain, debug
        self._tap()

        t0 = time.perf_counter()
        self.scene = ring.make_scene(self.cfg["scene"], self.seed)
        self.dbpath = os.path.join(self.workdir, "database.db")
        pairs, matches = ring.write_database(self.dbpath, self.scene,
                                             self.cfg["scene"])
        self.log(f"database: {pairs} pairs, {matches} matches in "
                 f"{time.perf_counter() - t0:.2f} s")
        self.sizes = dict(images=len(self.scene["seen"]), pairs=pairs,
                          matches=matches)
        self.dtype = getattr(torch, self.cfg["mapper"]["dtype"])
        t0 = time.perf_counter()
        self.run(keep=False)
        self.log(f"warm-up pass: {time.perf_counter() - t0:.2f} s")

    def _tap(self) -> None:
        """Keep each bundle-adjustment round's problem, start and result;
        the last kept in a pass is its final round."""
        from instantsfm_tpu_torch.pipeline import ba
        real = ba.optimize

        def optimize(problem, kernel, cfg, params, obs, *a, **kw):
            start = dict(q=params.cam["q"].detach().clone(),
                         t=params.cam["t"].detach().clone(),
                         intr=params.cam["intr"][:, :4].detach().clone(),
                         pts=params.pts.detach().clone())
            state, history = real(problem, kernel, cfg, params, obs, *a, **kw)
            p = state.params
            self._round = dict(
                start=start, obs=obs, steps=len(history),
                end=dict(q=p.cam["q"].detach(), t=p.cam["t"].detach(),
                         intr=p.cam["intr"][:, :4].detach(),
                         pts=p.pts.detach()))
            return state, history

        ba.optimize = optimize

        def untap():
            ba.optimize = real
        self._untap = untap

    def run(self, keep: bool = True) -> dict:
        """One pass; returns its work, the program's stage seconds and
        counters."""
        self._round = None
        self._debug.drain_stats()
        k1_start = self._k1.launches
        out = os.path.join(self.workdir, f"model_{len(self.answers)}")
        t0 = time.perf_counter()
        with record_function("sfmbench:read_colmap_database"):
            view_graph, cameras, images, feature_name = self._read(
                self.dbpath)
        db_read_s = time.perf_counter() - t0
        cameras, images, tracks, timings = self._solve(
            view_graph, cameras, images, self._Config(feature_name),
            dtype=self.dtype, log=lambda *a: None, device=self.device)
        t1 = time.perf_counter()
        with record_function("sfmbench:write_reconstruction"):
            self._write(out, cameras, images, tracks)
        write_s = time.perf_counter() - t1
        stats = self._debug.drain_stats()
        if keep:
            self.answers.append(dict(model=os.path.join(out, "0"),
                                     final_ba=self._round))
        spans = dict(timings, database_read=db_read_s, write=write_s)
        ra = stats.get("ra_syncs", [])
        counters = dict(
            ra_host_reads=sum(sum(d.values()) for d in ra),
            pcg_iters=sum(stats.get("pcg_iters", [])),
            gp_lm_iters=sum(stats.get("gp_lm_iters", [])),
            ba_lm_iters=sum(stats.get("ba_lm_iters", [])),
            k1_launches=self._k1.launches - k1_start,
            registered=int(images.registered.sum()))
        return dict(work=len(images.registered), spans=spans,
                    counters=counters)

    def release(self) -> None:
        if self._untap is not None:
            self._untap()
            self._untap = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def final_ba(self, rnd: dict) -> dict:
        """The final round's answer against the float64 optimum of its
        problem from its start: the answer's cost over the optimum's, less
        one.  Under the control the answer is the reference's own TF32
        solve from that start."""
        if rnd is None:
            return dict(final_ba_cost_excess=float("inf"))
        obs = rnd["obs"]
        valid = obs.valid
        cam = obs.cam_idx[valid].long()
        pt = obs.pt_idx[valid].long()
        xy = torch.stack([obs.data["x"][valid], obs.data["y"][valid]], 1)
        u_cam, cam = torch.unique(cam, return_inverse=True)
        u_pt, pt = torch.unique(pt, return_inverse=True)
        delta = float(self.cfg["mapper"]["ba_huber_delta"])

        def x_of(d, dtype):
            d = {k: v.to(dtype) for k, v in d.items()}
            return (ref.quat_xyzw_to_matrix(d["q"][u_cam]), d["t"][u_cam],
                    d["intr"][u_cam], d["pts"][u_pt])

        f64 = torch.float64
        problem = ref.Problem(cam, pt, xy, len(u_cam), len(u_pt), delta,
                              f64, self.device)
        x_opt, cost_opt, steps = ref.solve(problem, x_of(rnd["start"], f64),
                                           max_steps=100, rel_tol=1e-13)
        if self.control:
            low = ref.Problem(cam, pt, xy, len(u_cam), len(u_pt), delta,
                              torch.float32, self.device, tf32=True)
            x, _, _ = ref.solve(low, x_of(rnd["start"], torch.float32),
                                max_steps=rnd["steps"])
            x = tuple(v.to(f64) for v in x)
        else:
            x = x_of(rnd["end"], f64)
        self.log(f"final round: {len(cam)} observations, {len(u_cam)} "
                 f"cameras, {len(u_pt)} points, {rnd['steps']} steps; "
                 f"reference optimum {float(cost_opt):.9e} after {steps}")
        return dict(final_ba_cost_excess=float(problem.cost(x))
                    / float(cost_opt) - 1.0)

    def check(self, limits: dict) -> list:
        """Per answer, the numbers compared: the images left unregistered
        and the worst rotation error of the written model against the
        ground truth, and the final round of bundle adjustment against the
        reference (``final_ba``)."""
        truth = self.scene
        index = {ring.image_name(i): i for i in range(len(truth["seen"]))}
        rows = []
        for answer in self.answers:
            path = answer["model"]
            final = self.final_ba(answer["final_ba"])
            try:
                s = model_mod.score(model_mod.read_model(path), truth, index,
                                    truth["seen"])
            except (OSError, ValueError, IndexError) as exc:
                self.log(f"answer {path} unreadable: {exc!r}")
                rows.append(dict({k: float("inf") for k in limits}, **final))
                continue
            rows.append(dict(
                unregistered=float(len(truth["seen"]) - s["registered"]),
                rot_err_max_deg=s["rot_err_max_deg"], **final))
        return rows
