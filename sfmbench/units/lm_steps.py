"""Unit ``lm_steps``: bundle adjustment's LM steps on the ring's own problem.

Set-up draws the ring scene of the configuration from the seed and builds
the bundle-adjustment problem its visibility defines: every camera's
keypoint of every point it sees (``ring.ba_observations``), one
SIMPLE_RADIAL camera block per image (pose, focal length and radial
coefficient free), the points free.  The start perturbs the true poses,
focal lengths and points by the traffic's amounts, drawn from the seed.
The program's set-up (its bucketed layout) and one warm-up unit follow.

A unit is ``steps`` calls of the program's ``block_lm.lm_step`` from that
start, Huber loss; its answer is the final state.  After the window the
reference solves the same problem to convergence in float64
(``yardstick.ba_reference``) and judges each answer by its cost and
reprojections against that optimum, and the cost the program reported
against the reference's evaluation of it.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from yardstick import ba_reference as ref
from yardstick import ring

WORK = "iters"


def perturbed_start(scene: dict, obs: dict, traffic: dict, seed: int):
    """The true poses, intrinsics [C, 4] and kept points, and the start:
    each rotation turned by a random axis-angle of ``rot_deg`` degrees per
    axis, translations, points and focal lengths moved by gaussians of
    ``trans``, ``point`` and ``focal_rel`` (relative) scale."""
    rng = np.random.default_rng([seed, 1])
    p = traffic["perturb"]
    C = len(scene["R"])
    X = scene["points"][obs["point_ids"]]
    intr = np.tile(scene["intr"], (C, 1))
    w = np.radians(p["rot_deg"]) * rng.standard_normal((C, 3))
    E = ref.rodrigues(torch.as_tensor(w)).numpy()
    R0 = E @ scene["R"]
    t0 = scene["t"] + p["trans"] * rng.standard_normal((C, 3))
    intr0 = intr.copy()
    intr0[:, 0] *= 1.0 + p["focal_rel"] * rng.standard_normal(C)
    X0 = X + p["point"] * rng.standard_normal(X.shape)
    return (R0, t0, intr0, X0)


class Unit:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 workdir: str, log, control: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.log, self.control = device, log, control
        self.answers = []

    def setup(self) -> None:
        from instantsfm_tpu_torch.scene import cameras as cm
        from instantsfm_tpu_torch.solve import block_lm, robust
        from instantsfm_tpu_torch.solve.blocked import bucketize_problem
        from instantsfm_tpu_torch.solve.problems import make_ba_problem
        from instantsfm_tpu_torch.solve.schur_wchain import schur_wchain
        from instantsfm_tpu_torch.utils import debug
        self._lm, self._k1, self._debug = block_lm, schur_wchain, debug

        t0 = time.perf_counter()
        self.scene = ring.make_scene(self.cfg["scene"], self.seed)
        self.obs = ring.ba_observations(self.scene)
        self.start = perturbed_start(self.scene, self.obs, self.traffic,
                                     self.seed)
        R0, t0_, intr0, X0 = self.start
        dtype = getattr(torch, self.cfg["mapper"]["dtype"])
        dev = self.device
        T = lambda a, dt=dtype: torch.as_tensor(a).to(device=dev, dtype=dt)
        O = len(self.obs["cam"])
        q0 = ring.matrix_to_quat_xyzw(R0)
        params = block_lm.Params(
            cam={"q": T(q0), "t": T(t0_),
                 "intr": T(np.stack([cm.pad_params(v) for v in intr0]))},
            pts=T(X0), scales=torch.zeros((O, 1), dtype=dtype, device=dev),
            scales_free=torch.zeros(O, dtype=torch.bool, device=dev))
        observations = block_lm.Observations(
            cam_idx=T(self.obs["cam"], torch.int32),
            pt_idx=T(self.obs["pt"], torch.int32),
            data={"x": T(self.obs["xy"][:, 0]), "y": T(self.obs["xy"][:, 1])},
            valid=torch.ones(O, dtype=torch.bool, device=dev))
        self.problem = make_ba_problem(cm.SIMPLE_RADIAL)
        self.kernel = robust.huber(float(self.traffic["huber_delta"]))
        self.lm_cfg = block_lm.LMConfig(**self.traffic["lm"])
        self.params0, self.obs_b, self.buckets, slots = bucketize_problem(
            params, observations)
        self.slots = torch.as_tensor(slots, device=dev, dtype=torch.int64)
        self.lam0 = torch.tensor(1.0 / self.lm_cfg.radius_init, dtype=dtype,
                                 device=dev)
        self.sizes = dict(O=O, C=len(R0), T=len(X0),
                          PC=self.problem.cam_dim,
                          res_dim=self.problem.res_dim,
                          rows_padded=int(self.obs_b.valid.shape[0]))
        self.log(f"problem: {O} observations ({self.sizes['rows_padded']} "
                 f"rows laid out), {len(R0)} cameras, {len(X0)} points, "
                 f"set up in {time.perf_counter() - t0:.2f} s")
        if self.control:
            self.ctrl_problem = self.reference_problem(dtype, tf32=True)
            self.ctrl_x0 = tuple(T(a) for a in self.start)
        t0 = time.perf_counter()
        self.run(keep=False)
        self.log(f"warm-up unit: {time.perf_counter() - t0:.2f} s")

    def run(self, keep: bool = True) -> dict:
        if self.control:
            return self._run_control(keep)
        lm = self._lm
        self._debug.drain_stats()
        k1_start = self._k1.launches
        inf = torch.full_like(self.lam0, float("inf"))
        zero = torch.zeros_like(self.lam0)
        state = lm.LMState(self.params0, self.lam0, inf, zero, zero)
        steps = int(self.traffic["steps"])
        for _ in range(steps):
            with record_function("sfmbench:lm_step"):
                state = lm.lm_step(self.problem, self.kernel, self.lm_cfg,
                                   state, self.obs_b, buckets=self.buckets,
                                   device=self.device)
        cost = float(state.cost)            # waits for the last step
        stats = self._debug.drain_stats()
        if keep:
            p = state.params
            self.answers.append(dict(
                q=p.cam["q"].detach().clone(), t=p.cam["t"].detach().clone(),
                intr=p.cam["intr"][:, :4].detach().clone(),
                pts=p.pts[self.slots].detach().clone(), cost=cost))
        counters = dict(pcg_iters=sum(stats.get("pcg_iters", [])),
                        lm_tries=sum(stats.get("lm_tries", [])),
                        k1_launches=self._k1.launches - k1_start)
        return dict(work=steps, spans={}, counters=counters)

    def _run_control(self, keep: bool) -> dict:
        """The control in the program's place: the reference's own steps
        in float32 with every product in TF32."""
        steps = int(self.traffic["steps"])
        (R, t, intr, X), cost, _ = ref.solve(self.ctrl_problem, self.ctrl_x0,
                                             max_steps=steps)
        if keep:
            self.answers.append(dict(R=R, t=t, intr=intr, pts=X,
                                     cost=float(cost)))
        return dict(work=steps, spans={}, counters={})

    def release(self) -> None:
        self.params0 = self.obs_b = self.buckets = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_problem(self, dtype, tf32: bool = False):
        o = self.obs
        return ref.Problem(o["cam"], o["pt"], o["xy"], len(self.start[0]),
                           len(self.start[3]), self.traffic["huber_delta"],
                           dtype, self.device, tf32=tf32)

    def optimum(self):
        """The float64 reference's optimum from the start, and its cost."""
        problem = self.reference_problem(torch.float64)
        x0 = tuple(torch.as_tensor(a, dtype=torch.float64,
                                   device=self.device) for a in self.start)
        x, cost, steps = ref.solve(problem, x0, max_steps=100,
                                   rel_tol=1e-13)
        self.log(f"reference optimum: cost {float(cost):.9e} after "
                 f"{steps} steps")
        return problem, x, float(cost)

    def check(self, limits: dict) -> list:
        """Per answer: its cost over the optimum's, less one; the RMS and
        the largest over observations of its reprojections' distance from
        the optimum's, in pixels; and the gap between the cost it reported
        and the cost of its parameters, as a share of the latter."""
        problem, x_opt, cost_opt = self.optimum()
        r_opt, _ = problem.residuals(x_opt)
        rows = []
        for a in self.answers:
            d = lambda v: v.to(torch.float64)
            R = a["R"] if "R" in a else ref.quat_xyzw_to_matrix(d(a["q"]))
            x = (d(R), d(a["t"]), d(a["intr"]), d(a["pts"]))
            r, _ = problem.residuals(x)
            cost = float(problem.cost(x))
            gap = torch.linalg.norm(r - r_opt, dim=1)
            rows.append(dict(
                cost_excess=cost / cost_opt - 1.0,
                reproj_gap_px=float(torch.sqrt(torch.mean(gap * gap))),
                reproj_gap_max_px=float(gap.max()),
                reported_cost_gap=abs(a["cost"] - cost) / cost))
        return rows
