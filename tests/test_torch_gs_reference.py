"""The port's 3DGS training step against the plain reference
(``reference/gs_plain.py``: gsplat's default trainer written from the
method, in float64), on the CPU at small sizes.

* One step of the port's ``Runner`` from a trained state: the image, the
  loss, every leaf's gradient and Adam update, and the strategy's
  accumulation (the probe's gradient times W / 2 and H / 2, as gsplat
  normalises it); then the refine's grow, split and prune sets on that
  state, and the pool they leave.  The port composites in float32 and, where a pixel saturates,
  past the gaussian that takes its transmittance under 1e-4, up to the
  end of the 128-row chunk (the reference stops before it): the bars are
  those float32 and that rule leave at this size.
* A gaussian whose 3-sigma box covers more than 16 tiles and a tile that
  holds more than 512 gaussians, rendered with no pair cut, as the
  reference renders them; the JAX package's budgets cut both.
* ``Runner.step`` repeated is ``train()``, bit for bit; each train view
  is decoded once and kept; and
  ``state_dict``/``load_state_dict`` replays a block of steps with a
  refine in it exactly.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from reference import gs_plain as ref
from tests.torch_cpu import lean_cpu  # noqa: F401  (module fixture)
from instantsfm_tpu_torch.gs import rasterize as traster
from instantsfm_tpu_torch.gs import strategy as tst
from instantsfm_tpu_torch.gs.trainer import GSConfig, Runner
from instantsfm_tpu_torch.utils import debug

LEAVES = ref.LEAVES


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gs_ref_scene"))
    chip_smoke.make_gs_scene(root, "cpu", 300, 6, 96, 72)
    return root


def _runner(scene, out, **kw):
    cfg = dict(data_dir=scene, result_dir=str(out), test_every=3,
               sh_degree_interval=2, eval_steps=(), save_steps=(),
               tb_every=0, capacity_mult=2.0)
    cfg.update(kw)
    return Runner(GSConfig(**cfg), log=lambda *a: None, device="cpu")


def _rel(a, b):
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def test_port_step_matches_reference(scene, tmp_path):
    r = _runner(scene, tmp_path)
    with torch.no_grad():     # anisotropic: the rotations' gradients count
        r.splats.scales.add_(0.3 * torch.randn(
            r.splats.scales.shape, generator=torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(3)
    for step in range(6):                 # SH degree 3 from step 6 on
        r.step(step, rng)
    sd = r.state_dict()
    seen = {}
    views, render = r._views, r._render
    r._views = lambda g: seen.setdefault("views", views(g))
    r._render = lambda *a, **k: seen.setdefault("out", render(*a, **k))
    loss = r.step(6, rng)
    del r._views, r._render
    v = seen["views"][0]
    alive = sd["splats"]["alive"]
    want = ref.step({k: sd["splats"][k] for k in LEAVES}, alive,
                    {k: sd["adam"][k]["state"] for k in LEAVES},
                    sd["n_updates"], r.scene_scale, r.cfg.max_steps,
                    torch.linalg.inv(v["camtoworld"].double()), v["K"],
                    v["image"], 3)
    assert abs(loss - want.loss) <= 1e-6 * want.loss
    assert _rel(seen["out"].rgb.detach(), want.image) <= 5e-6
    sp = r.splats
    for f in LEAVES:
        assert _rel(getattr(sp, f).grad[alive], want.grads[f][alive]) \
            <= 2e-4, f
        upd = getattr(sp, f).detach().double() - sd["splats"][f].double()
        assert _rel(upd[alive], want.updates[f][alive]) <= 2e-4, f
    acc = r.strategy_state.grad2d_sum - sd["strategy"][0]
    assert _rel(acc[alive], want.accum[alive]) <= 1e-4
    assert torch.equal((r.strategy_state.count - sd["strategy"][1])[alive]
                       > 0, want.seen[alive])

    # the refine on this state: faint, oversized and hot rows planted
    pool = r.splats
    with torch.no_grad():
        idx = torch.nonzero(pool.alive)[:, 0]
        ss = r.scene_scale
        pool.opacities[idx[:20]] = -8.0
        pool.scales[idx[20:40]] = np.log(0.3 * ss)      # oversized
        pool.scales[idx[40:70]] = np.log(0.002 * ss)    # hot: duplicate
        pool.scales[idx[70:100]] = np.log(0.05 * ss)    # hot: split
        r.strategy_state.grad2d_sum[idx[40:100]] += 0.05
        r.strategy_state.count[idx[40:100]] += 1
    pre = {f: getattr(pool, f).detach().clone() for f in LEAVES}
    pre.update(alive=pool.alive.clone(),
               grad2d=r.strategy_state.grad2d_sum.clone(),
               count=r.strategy_state.count.clone())
    noise = torch.randn((pool.alive.shape[0], 3), generator=r.generator)
    rec = {}
    tst.refine(pool, r.optimizer, r.strategy_state, r.scene_scale,
               prune_too_big=True, noise=noise, record=rec)
    want = ref.refine_decisions(pre["scales"], pre["opacities"],
                                pre["alive"], pre["grad2d"], pre["count"],
                                r.scene_scale, True)
    judged = want["margin"] > 1e-5
    for k in ("dupli", "split", "grown", "prune"):
        assert torch.equal(rec[k] & judged, want[k] & judged), k
    assert all(int(want[k].sum()) > 0 for k in ("dupli", "split", "prune"))
    # the pool the decisions leave: children placed, moved and shrunk,
    # the pruned dropped, the touched rows' moments restarted
    leaves, alive, zeroed = ref.refine_writes(
        {f: pre[f] for f in LEAVES}, pre["alive"], rec["split"],
        rec["grown"], rec["prune"], noise)
    assert torch.equal(pool.alive, alive)
    for f in LEAVES:
        torch.testing.assert_close(getattr(pool, f).detach().double(),
                                   leaves[f], rtol=1e-6, atol=1e-6)
    for g in r.optimizer.param_groups:
        m = r.optimizer.state[g["params"][0]]["exp_avg"]
        assert not m[zeroed].any(), g["name"]


def _gaussians(n, centre, scale, opacity, seed):
    g = torch.Generator().manual_seed(seed)
    return dict(means=centre + 0.02 * torch.randn((n, 3), generator=g,
                                                  dtype=torch.float64),
                quats=torch.randn((n, 4), generator=g, dtype=torch.float64),
                scales=torch.full((n, 3), scale, dtype=torch.float64),
                opac=torch.full((n,), opacity, dtype=torch.float64),
                sh=0.3 * torch.randn((n, 16, 3), generator=g,
                                     dtype=torch.float64))


@pytest.mark.parametrize("case", ["wide gaussian", "full tile"])
def test_no_pair_is_cut(case):
    """A gaussian covering 8 x 8 tiles, and 700 faint gaussians in
    one tile (none saturates a pixel): the port's render keeps every pair
    and matches the reference; under the JAX package's 16-tile / 512-slot
    budgets the same view loses pairs (``gs_pairs_cut``)."""
    W, H = 192, 160
    if case == "wide gaussian":
        g = _gaussians(1, torch.tensor([0.0, 0.0, 4.0], dtype=torch.float64),
                       0.6, 0.8, 0)
    else:
        # inside the tile of pixels 96..112 x 80..96, transparent enough
        # that no pixel saturates
        g = _gaussians(700, torch.tensor([0.27, 0.27, 4.0],
                                         dtype=torch.float64),
                       0.004, 0.0045, 1)
    view = torch.eye(4, dtype=torch.float64)
    K = torch.tensor([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]],
                     dtype=torch.float64)
    proj = ref.project(g["means"], g["quats"], g["scales"], view, K, W, H)
    img = ref.render(proj, ref.sh_colors(3, g["sh"], g["means"],
                                         torch.zeros(3, dtype=torch.float64)),
                     g["opac"], W, H)
    f = lambda a: a.float()
    args = (f(g["means"]), f(g["quats"]), f(g["scales"]), f(g["opac"]),
            f(g["sh"]), f(view), f(K), W, H)
    cuts = {}
    for budget in (None, (16, 512)):
        debug.drain_stats()
        kw = {} if budget is None else dict(tiles_per_gauss=budget[0],
                                            tile_capacity=budget[1])
        out = traster.rasterize(*args, sh_degree=3, **kw)
        stats = debug.drain_stats()
        cuts[budget] = (sum(stats["gs_pairs_cut"]), _rel(out.rgb, img))
    pairs = sum(stats["gs_pairs"])
    assert pairs > (16 if case == "wide gaussian" else 512)
    assert cuts[None] == (0, pytest.approx(0, abs=2e-6))
    assert cuts[(16, 512)][0] > 0 and cuts[(16, 512)][1] > 1e-3


def test_runner_step_is_train(scene, tmp_path):
    a = _runner(scene, tmp_path / "a", max_steps=4)
    b = _runner(scene, tmp_path / "b", max_steps=4)
    losses = a.train()
    rng = np.random.default_rng(0)
    assert [b.step(s, rng) for s in range(4)] == losses
    for f in LEAVES + ("alive",):
        assert torch.equal(getattr(a.splats, f), getattr(b.splats, f)), f


def test_train_views_are_decoded_once(scene, tmp_path):
    """Each train view is decoded at its first use and kept on the device:
    later steps read the kept image, equal to the decoded one."""
    r = _runner(scene, tmp_path)
    load = r.parser.load_image
    loads = []
    r.parser.load_image = lambda idx: loads.append(idx) or load(idx)
    rng = np.random.default_rng(4)
    for step in range(12):
        r.step(step, rng)
    assert sorted(loads) == sorted(set(loads)) and len(loads) == len(r._images)
    for i, img in r._images.items():
        assert torch.equal(img, torch.as_tensor(r.trainset[i]["image"]))


def test_state_dict_replays_a_unit(scene, tmp_path):
    """Steps 3-6 twice from the state after step 2, a refine at step 6
    (its split noise drawn from the generator the state holds): the
    losses, the pool, the moments and the strategy state come out the
    same; the saved copy is untouched by the steps."""
    r = _runner(scene, tmp_path)
    r.strategy_cfg = tst.StrategyConfig(refine_start_iter=2, refine_every=3,
                                        grow_grad2d=1e-3)
    rng = np.random.default_rng(1)
    for step in range(3):
        r.step(step, rng)
    sd = r.state_dict()
    means0 = sd["splats"]["means"].clone()

    def unit():
        r.load_state_dict(sd)
        g = np.random.default_rng(2)
        losses = [r.step(s, g) for s in range(3, 7)]
        return losses, r.state_dict()

    (l1, s1), (l2, s2) = unit(), unit()
    assert l1 == l2
    assert r.refines[-1]["step"] == 6 and r.refines[-1]["grown"] > 0
    assert torch.equal(sd["splats"]["means"], means0)
    for f in s1["splats"]:
        assert torch.equal(s1["splats"][f], s2["splats"][f]), f
    for k in LEAVES:
        for m, v in s1["adam"][k]["state"].items():
            assert torch.equal(v, s2["adam"][k]["state"][m]), (k, m)
    for a, b in zip(s1["strategy"], s2["strategy"]):
        assert torch.equal(a, b)
    assert s1["n_updates"] == s2["n_updates"] == 7
