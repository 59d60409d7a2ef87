"""Unit ``gs_steps``: 3DGS training steps through the program's ``Runner``.

Set-up writes the configuration's scene from the seed into the run's
directory (``yardstick.gs_scene``: ground-truth splats, the views rendered
by the plain reference and written as 8-bit PNG, a COLMAP model of the
noisy SfM points), builds the program's ``Runner(GSConfig(...))`` on it
with the configuration's options, trains steps 0 to ``setup_steps``
through ``Runner.step`` on views drawn from the seed, and keeps the
training state (``Runner.state_dict``).  A warm-up unit follows, in which
the harness counts each view's compositing work on the kernels' inputs
(``composite.pair_counts``: the chunks K2 entered, their live pairs)
beside the rasterizer's pair counters; the roofline readers take these
as the window's.

A unit restores that state (``Runner.load_state_dict``) and runs the
traffic's ``steps`` steps after it, on views drawn from the seed, the last
step a refine: every unit does the same work.  A step trains on one view
(batch 1), so the unit's work is counted in training images, one a step.
Its answers are its first and last steps, each from the training state
before it (the view, the rendered image, the loss, every leaf's gradient
and Adam update, the strategy's accumulation), its refine (the pool before
it, the rows duplicated, split, grown and pruned, and the rows it wrote),
and the pairs the rasterizer cut in the unit.  After the window the plain
reference (``yardstick.gs_reference``) recomputes those steps in float64
from the program's state and the harness's own target images, and the
refine's decisions and writes from the pool the program handed it; the
window's first and last units and the profiled unit are judged.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled

from yardstick import gs_reference as ref
from yardstick import gs_scene

WORK = "images"   # training images: one view a step
LEAVES = ref.LEAVES
MARGIN = 1e-5     # refine decisions this close to a threshold are not judged


def _rel(a, b):
    """||a - b|| / ||b||, float64."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    n = float(torch.linalg.norm(b))
    return float(torch.linalg.norm(a - b)) / n if n > 0 else (
        0.0 if float(torch.linalg.norm(a)) == 0 else float("inf"))


def _rows(x):
    """[N, ...] bool -> [N]: any element of each row."""
    return x.reshape(x.shape[0], -1).any(1)


class Unit:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 workdir: str, log, control: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.workdir, self.log = device, workdir, log
        self.control = control
        self.answers = {}
        self.sizes = {}
        self.window = []         # whether each kept unit ran profiled

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from instantsfm_tpu_torch.gs import trainer
        if not (hasattr(trainer.Runner, "step")
                and hasattr(trainer.Runner, "state_dict")):
            raise RuntimeError("the program's gs.trainer.Runner has no "
                               "step() and state_dict(): it cannot run a "
                               "block of training steps")
        from instantsfm_tpu_torch.gs import composite, rasterize, strategy
        from instantsfm_tpu_torch.utils import debug
        self._raster, self._strategy, self._debug = rasterize, strategy, debug

        t0 = time.perf_counter()
        root = os.path.join(self.workdir, "scene")
        self.scene = gs_scene.write(root, self.cfg["scene"], self.seed,
                                    self.device)
        self.log(f"scene: {self.cfg['scene']['num_gaussians']} gaussians, "
                 f"{len(self.scene['views'])} views rendered and written in "
                 f"{time.perf_counter() - t0:.2f} s")
        opts = dict(self.cfg["program"]["gsconfig"])
        self.runner = trainer.Runner(
            trainer.GSConfig(data_dir=root, result_dir=os.path.join(
                self.workdir, "results"), **opts),
            log=lambda *a: None, device=self.device)
        r = self.runner
        self.log(f"pool of {r.splats.alive.shape[0]} slots, "
                 f"{r.num_alive()} alive; scene scale {r.scene_scale:.4f}")
        t0 = time.perf_counter()
        rng = np.random.default_rng([self.seed, 1])
        last = int(self.cfg["setup_steps"])
        for step in range(last + 1):
            r.step(step, rng)
            if step % 1000 == 0 or step == last:
                self.log(f"set-up step {step}: {r.num_alive()} alive, "
                         f"{time.perf_counter() - t0:.1f} s")
        self.state0 = r.state_dict()
        self.alive0 = self.state0["splats"]["alive"]
        self.first = last + 1
        debug.drain_stats()

        # the warm-up unit, the harness counting each view's compositing
        # work on the kernels' inputs: the chunks K2's walk entered and
        # the live pairs in them
        t0 = time.perf_counter()
        work = {"gs_chunks_entered": [], "gs_live_pairs": []}
        real = rasterize.tile_attrs

        def counted(*a, **kw):
            attrs, nchunks, ntx = out = real(*a, **kw)
            with torch.no_grad():
                at = attrs.detach()
                w = composite.pair_counts(
                    at, composite.composite_fwd(at, nchunks, ntx)[1], ntx,
                    batch=2048)
            work["gs_chunks_entered"].append(w["chunks_entered"])
            work["gs_live_pairs"].append(w["live_pairs"])
            return out

        rasterize.tile_attrs = counted
        try:
            rec = self.run(keep=False)
        finally:
            rasterize.tile_attrs = real
        c = rec["counters"]
        self.log(f"the unit's refine: {c.get('gs_grown', 0)} grown, "
                 f"{c.get('gs_grow_dropped', 0)} without a slot, "
                 f"{c.get('gs_pruned', 0)} pruned, {c.get('gs_alive', 0)} "
                 f"alive after it; pairs cut {c.get('gs_pairs_cut', 0)}")
        st = {**self._work_stats, **work}
        mean = lambda k: sum(st.get(k, [0])) / max(len(st.get(k, [])), 1)
        W, H = self.scene["width"], self.scene["height"]
        self.sizes = dict(
            G=int(self.alive0.sum()), width=W, height=H,
            tiles=-(-W // 16) * -(-H // 16), steps=int(self.traffic["steps"]),
            work=dict(G=int(self.alive0.sum()),
                      sh_degree=self._sh_degree(self.first), width=W,
                      height=H, intersections=mean("gs_pairs"),
                      kept=mean("gs_pairs") - mean("gs_pairs_cut"),
                      chunks_entered=mean("gs_chunks_entered"),
                      live_pairs=mean("gs_live_pairs")))
        self.log(f"warm-up unit (work counted): "
                 f"{time.perf_counter() - t0:.2f} s; a step "
                 f"{self.sizes['work']}")

    def _sh_degree(self, step: int) -> int:
        t = self.cfg["trainer"]
        return min(step // t["sh_degree_interval"], t["sh_degree"])

    # -------------------------------------------------------------- unit

    def run(self, keep: bool = True) -> dict:
        r, debug = self.runner, self._debug
        debug.drain_stats()
        r.load_state_dict(self.state0)
        rng = np.random.default_rng([self.seed, 2])
        steps = int(self.traffic["steps"])
        last = self.first + steps - 1
        tap = {} if keep else None
        for step in range(self.first, last + 1):
            if tap is None or self.first < step < last:
                r.step(step, rng)
            elif step == self.first:
                tap["first"] = self._tap_step(step, rng, self.state0)
            else:
                tap["last"] = self._tap_step(step, rng, r.state_dict())
        stats = debug.drain_stats()
        self._work_stats = stats
        counters = {k: sum(v) for k, v in stats.items()
                    if k.startswith("gs_")}
        if tap is not None:
            tap["pairs_cut"] = counters.get("gs_pairs_cut", 0)
            which = "profiled" if _profiler_enabled() else (
                "last" if "first" in self.answers else "first")
            self.answers[which] = tap
            self.window.append(which == "profiled")
        return dict(work=steps, spans={}, counters=counters)

    def _tap_step(self, step: int, rng, before: dict) -> dict:
        """Run ``step`` from the training state ``before`` (a
        ``state_dict``), keeping its view, image, loss, every leaf's
        gradient and value after Adam, and the strategy's sums after its
        accumulation; where the step refines, also the pool the refine is
        handed, its decisions and draws, and the pool it leaves."""
        r = self.runner
        tap = dict(step=step, before=before)
        views, render = r._views, r._render

        def tap_views(g):
            out = views(g)
            tap["image_id"] = int(out[0]["image_id"])
            return out

        def tap_render(*a, **k):
            out = render(*a, **k)
            tap["image"] = out.rgb.detach().clone()
            return out

        def after_update(splats, state):
            tap.update(
                grads={f: getattr(splats, f).grad.detach().clone()
                       for f in LEAVES},
                after={f: getattr(splats, f).detach().clone()
                       for f in LEAVES},
                grad2d=state.grad2d_sum.detach().clone())

        r._views, r._render = tap_views, tap_render
        try:
            with self._tap_refine(tap, after_update):
                tap["loss"] = r.step(step, rng)
        finally:
            del r._views, r._render
        if "grads" not in tap:
            after_update(r.splats, r.strategy_state)
        return tap

    @contextlib.contextmanager
    def _tap_refine(self, tap: dict, after_update):
        """Keep the pool the refine is handed, its decisions, the standard
        normals of its split children and the pool it leaves."""
        mod = self._strategy
        real = mod.refine

        def refine(splats, optimizer, state, scene_scale, *a, **kw):
            after_update(splats, state)
            moments = lambda: {g["name"]: {
                k: optimizer.state[g["params"][0]][k].detach().clone()
                for k in ("exp_avg", "exp_avg_sq")}
                for g in optimizer.param_groups}
            pre = dict(tap["after"], alive=splats.alive.clone(),
                       grad2d=state.grad2d_sum.clone(),
                       count=state.count.clone(),
                       scene_scale=float(scene_scale),
                       prune_too_big=bool(kw.get("prune_too_big", False)),
                       moments=moments())
            # the draws the refine would make itself, handed to it
            if kw.get("noise") is None:
                kw["noise"] = torch.randn(
                    (splats.alive.shape[0], 3), generator=kw.get("generator"),
                    device=splats.alive.device, dtype=splats.means.dtype)
            pre["noise"] = kw["noise"].clone()
            rec = kw.get("record")
            kw["record"] = rec = {} if rec is None else rec
            out = real(splats, optimizer, state, scene_scale, *a, **kw)
            tap["pre"] = pre
            tap["decisions"] = {k: rec[k].clone() for k in
                                ("dupli", "split", "grown", "prune")}
            tap["post"] = dict({f: getattr(splats, f).detach().clone()
                                for f in LEAVES},
                               alive=splats.alive.clone(), moments=moments())
            return out

        mod.refine = refine
        try:
            yield
        finally:
            mod.refine = real

    def release(self) -> None:
        """Log where the window's steps spent their time, by span."""
        steps = int(self.traffic["steps"])
        n = self.window.count(False) * steps
        roots = self._debug.REGISTRY.roots("gs.step")
        roots = roots[len(roots) - len(self.window) * steps:][:n]
        if roots:
            tot = {}
            for r in roots:
                for k, (c, t, own) in r["spans"].items():
                    acc = tot.setdefault(k, [0.0, 0.0])
                    acc[0] += t
                    acc[1] += own
            self.log("the window's step by span, ms a step (total, self): "
                     + ", ".join(f"{k} {1e3 * t / n:.2f} {1e3 * o / n:.2f}"
                                 for k, (t, o) in sorted(
                                     tot.items(), key=lambda kv: -kv[1][0])))
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def _frame(self):
        """The harness's own cameras in the program's world frame: the
        program picks the frame (the 4 x 4 similarity its parser applied,
        ``Parser.transform``, which must be one), and the cameras, K and
        the scene scale (gsplat's: 1.1 times the largest distance of a
        camera centre from their mean) are the harness's."""
        T = np.asarray(self.runner.parser.transform, np.float64)
        A = T[:3, :3]
        s = np.cbrt(np.linalg.det(A))
        if not (s > 0 and np.allclose(A.T @ A, s * s * np.eye(3),
                                      rtol=0, atol=1e-9 * s * s)
                and np.allclose(T[3], [0, 0, 0, 1])):
            raise RuntimeError("the program's world frame is not a "
                               "similarity of the scene's")
        viewmats, centres = [], []
        for R, t in self.scene["views"]:
            c = -R.T @ t
            cp = A @ c + T[:3, 3]
            Rp = R @ (A / s).T             # world (program) to camera
            view = np.eye(4)
            view[:3, :3], view[:3, 3] = Rp, -Rp @ cp
            viewmats.append(view)
            centres.append(cp)
        centres = np.stack(centres)
        scale = 1.1 * float(np.max(np.linalg.norm(
            centres - centres.mean(0), axis=-1)))
        return viewmats, scale

    def _reference_step(self, tap: dict, prec):
        b = tap["before"]
        t = self.cfg["trainer"]
        view = torch.as_tensor(self.viewmats[tap["image_id"]],
                               device=self.device)
        gt = torch.as_tensor(self.scene["targets"][tap["image_id"]],
                             device=self.device).to(prec.dtype) / 255.0
        return ref.step(
            {k: b["splats"][k] for k in LEAVES}, b["splats"]["alive"],
            {k: b["adam"][k]["state"] for k in LEAVES}, b["n_updates"],
            self.scene_scale, t["max_steps"], view.to(prec.dtype),
            torch.as_tensor(self.scene["K"], device=self.device).to(
                prec.dtype), gt, self._sh_degree(tap["step"]), prec)

    def check(self, limits: dict) -> list:
        """Per judged unit, the worst of its first step (from the state
        after the set-up) and its last (from the unit's own state before
        it), each recomputed by the reference in float64 with the
        harness's cameras and scene scale: the loss's relative gap; the
        image's RMS gap over its RMS; for the worst leaf, ||gap|| /
        ||reference|| over the alive rows of the gradient, and of the Adam
        update against the reference's Adam step of the answer's own
        gradients (the gradients are judged apart: where the port
        composites past a saturated pixel, a gaussian behind it gets a
        tiny gradient where the reference's is zero, and Adam moves a row
        with small moments by about its learning rate either way, so an
        update judged on the reference's gradients would count that twice;
        the log gives that reading too); the same of the strategy's
        accumulation.  Of the last step's refine: the rows decided
        otherwise (outside a band of ``MARGIN`` around each threshold),
        with the rows whose pool or Adam moments after it do not follow
        the program's own decisions; the worst leaf's gap over the rows
        it wrote.  The pairs the rasterizer cut in the unit."""
        order = [k for k in ("first", "last", "profiled") if k in self.answers]
        if not order:
            return []
        t0 = time.perf_counter()
        self.viewmats, self.scene_scale = self._frame()
        self.log(f"scene scale {self.scene_scale:.9g} (the program's "
                 f"{self.runner.scene_scale:.9g})")
        first = None                  # every unit's first step is the same
        rows = []
        for k in order:
            a = self.answers[k]
            got = []
            for which in ("first", "last"):
                tap = a[which]
                if which == "first" and first is not None:
                    want = first
                else:
                    want = self._reference_step(tap, ref.F64)
                    if which == "first":
                        first = want
                ctl = self._reference_step(
                    tap, ref.Precision(torch.float32, tf32=True)) \
                    if self.control else None
                got.append(self._judge_step(k, tap, want, ctl))
            row = {m: max(g[m] for g in got) for m in got[0]}
            mismatch, write_err = self._judge_refine(a["last"])
            row.update(refine_mismatch=float(mismatch),
                       refine_write_err=write_err,
                       pairs_cut=float(a["pairs_cut"]))
            rows.append(row)
        self.log(f"reference steps and refines judged in "
                 f"{time.perf_counter() - t0:.2f} s")
        return rows

    def _judge_step(self, k: str, tap: dict, want, ctl) -> dict:
        b = tap["before"]
        alive = b["splats"]["alive"]
        before = {f: b["splats"][f].to(torch.float64) for f in LEAVES}
        if ctl is not None:
            img, loss, grads = ctl.image, ctl.loss, ctl.grads
            upd, acc = ctl.updates, ctl.accum
        else:
            img, loss, grads = tap["image"], tap["loss"], tap["grads"]
            upd = {f: tap["after"][f].to(torch.float64) - before[f]
                   for f in LEAVES}
            acc = tap["grad2d"] - b["strategy"][0]
        # the Adam step of the answer's own gradients, in float64
        adam = ref.adam_updates(
            {f: grads[f].to(torch.float64) for f in LEAVES},
            {f: b["adam"][f]["state"] for f in LEAVES}, b["n_updates"],
            self.scene_scale, self.cfg["trainer"]["max_steps"])
        leaf = {f: (_rel(grads[f][alive], want.grads[f][alive]),
                    _rel(upd[f][alive], adam[f][alive]),
                    _rel(upd[f][alive], want.updates[f][alive]))
                for f in LEAVES}
        self.log(f"{k} unit, step {tap['step']} (view {tap['image_id']}), "
                 f"by leaf (gradient, update of its own gradient, update of "
                 f"the reference's): "
                 + ", ".join(f"{f} {g:.3g} {u:.3g} {w:.3g}"
                             for f, (g, u, w) in leaf.items()))
        d = img.to(torch.float64) - want.image
        return dict(
            loss_gap=abs(loss - want.loss) / abs(want.loss),
            render_rel_err=float(torch.sqrt(torch.mean(d * d))
                                 / torch.sqrt(torch.mean(
                                     want.image * want.image))),
            grad_rel_err=max(v[0] for v in leaf.values()),
            update_rel_err=max(v[1] for v in leaf.values()),
            accum_rel_err=_rel(acc[alive], want.accum[alive]))

    def _judge_refine(self, tap: dict):
        """(rows decided or written otherwise, the worst leaf's relative
        gap over the rows the refine wrote)."""
        pre = tap.get("pre")
        if pre is None:
            return 10 ** 9, float("inf")   # no refine ran
        want = ref.refine_decisions(pre["scales"], pre["opacities"],
                                    pre["alive"], pre["grad2d"], pre["count"],
                                    self.scene_scale, pre["prune_too_big"])
        got = tap["decisions"]
        differ = torch.zeros_like(pre["alive"])
        for k in ("dupli", "split", "grown", "prune"):
            differ |= got[k] != want[k]
        decided = int((differ & (want["margin"] > MARGIN)).sum())
        # the pool the program's own decisions leave
        leaves, alive, zeroed = ref.refine_writes(
            {f: pre[f] for f in LEAVES}, pre["alive"], got["split"],
            got["grown"], got["prune"], pre["noise"])
        post = tap["post"]
        wrote = torch.zeros_like(alive)
        wrote[torch.nonzero(~pre["alive"])[:, 0][:int(got["grown"].sum())]] \
            = True
        wrote |= got["split"] & got["grown"]
        bad = post["alive"] != alive
        err = 0.0
        for f in LEAVES:
            p = post[f].to(torch.float64)
            err = max(err, _rel(p[wrote], leaves[f][wrote]))
            keep = ~wrote
            bad |= _rows(p != pre[f].to(torch.float64)) & keep
        for name, m in post["moments"].items():
            for kind, v in m.items():
                was = pre["moments"][name][kind]
                z = zeroed.view((-1,) + (1,) * (v.dim() - 1))
                bad |= _rows(torch.where(z, v != 0, v != was))
        return decided + int(bad.sum()), err

