"""Gaussian-sharded 3DGS rendering and training step over several ranks.

Counterpart of ``instantsfm_tpu/gs/distributed.py`` (gsplat's
``distributed=True`` rasterization with DDP):

* the splat pool is cut into contiguous equal shards, one per rank of the
  default process group (``pad_splats`` makes the capacity divide by the
  world);
* each rank projects ITS gaussians for ALL B views of the batch
  (``rasterize.project_view``), then one ``all_to_all`` regroups the
  screen-space gaussians so that each rank composites ALL gaussians for ITS
  B/D views (``rasterize.rasterize_projected``, kernels K2/K3 on the card).
  The exchange is an autograd function whose backward is the reverse
  all-to-all;
* the loss is averaged over the ranks; the splat gradients come out
  shard-local, so each rank's Adam steps its own shard with no further
  communication.

Every rank is handed the same batch (the same views in the same order);
rank r composites views [r*B/D, (r+1)*B/D).  The batch size must divide by
the world size, and every view must have the same size.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.distributed as dist

from instantsfm_tpu_torch.gs import rasterize as raster_mod
from instantsfm_tpu_torch.gs import ssim as ssim_mod
from instantsfm_tpu_torch.gs.splats import FIELDS, Splats
from instantsfm_tpu_torch.parallel.multihost import \
    all_gather_rows as gather_rows

# Projected2D fields in the order of the exchanged [.., 12] rows
_PARTS = (("means2d", 2), ("conics", 3), ("depths", 1), ("radii", 1),
          ("valid", 1), ("colors", 3), ("opac", 1))


def pad_splats(splats: Splats, n_dev: int) -> Splats:
    """Pad the pool so that its capacity divides by ``n_dev`` (the padding
    rows are dead and zero)."""
    G = splats.means.shape[0]
    pad = (-G) % n_dev
    if pad == 0:
        return splats
    f = lambda a: torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    return Splats(**{k: f(getattr(splats, k)) for k in FIELDS})


def shard_splats(splats: Splats, rank: int, world: int) -> Splats:
    """Rank ``rank``'s contiguous shard of a padded pool (fresh tensors)."""
    n = splats.means.shape[0] // world
    return Splats(**{k: getattr(splats, k)[rank * n:(rank + 1) * n]
                     .detach().clone() for k in FIELDS})


def gather_splats(splats: Splats) -> Splats:
    """The whole pool on every rank (a copy)."""
    return Splats(**{k: gather_rows(getattr(splats, k)) for k in FIELDS})


class _Exchange(torch.autograd.Function):
    """[B, G_loc, F] on each rank -> [B/D, D*G_loc, F]: view block r goes to
    rank r and the gaussian blocks are concatenated in rank order (JAX's
    ``all_to_all(split_axis=0, concat_axis=1, tiled=True)``)."""

    @staticmethod
    def forward(ctx, x):
        D = dist.get_world_size()
        B, G = x.shape[0], x.shape[1]
        send = x.reshape((D, B // D) + tuple(x.shape[1:])).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        # recv[s] = rank s's gaussians for this rank's views
        return recv.transpose(0, 1).reshape(
            (B // D, D * G) + tuple(x.shape[2:]))

    @staticmethod
    def backward(ctx, g):
        D = dist.get_world_size()
        b, GD = g.shape[0], g.shape[1]
        send = g.reshape((b, D, GD // D) + tuple(g.shape[2:])) \
            .transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        # recv[s] = the gradient of my gaussians from rank s's views
        return recv.reshape((D * b, GD // D) + tuple(g.shape[2:]))


def exchange(ps):
    """A list of B per-view ``Projected2D`` of the rank's G_loc gaussians ->
    B/D ``Projected2D`` of all gaussians, for this rank's views."""
    rows = torch.stack([torch.cat([
        getattr(p, name).reshape(p.means2d.shape[0], width).to(
            p.means2d.dtype)
        if name not in ("radii", "valid") else
        getattr(p, name).detach().reshape(-1, 1).to(p.means2d.dtype)
        for name, width in _PARTS], dim=1) for p in ps])
    full = _Exchange.apply(rows)
    out, lo = [], 0
    cols = {}
    for name, width in _PARTS:
        cols[name] = full[..., lo:lo + width]
        lo += width
    for v in range(full.shape[0]):
        f = {k: c[v] for k, c in cols.items()}
        out.append(raster_mod.Projected2D(
            means2d=f["means2d"], conics=f["conics"], depths=f["depths"][:, 0],
            radii=f["radii"][:, 0], valid=f["valid"][:, 0] > 0.5,
            colors=f["colors"], opac=f["opac"][:, 0]))
    return out


def distributed_loss(splats: Splats, offset, batch, width: int, height: int,
                     sh_degree: int, ssim_lambda: float = 0.2,
                     tiles_per_gauss=None, tile_capacity=None,
                     opacity_reg: float = 0.0, scale_reg: float = 0.0,
                     camera_model: str = "pinhole"):
    """Returns (objective, loss, radii_max [G_loc], seen [G_loc], rgb
    [B/D, H, W, 3]).

    ``splats`` and ``offset`` (the [G_loc, 2] screen-space probe) are the
    rank's shard; ``batch`` holds ``camtoworld`` [B, 4, 4] and ``K``
    [B, 3, 3] of all B views and ``image`` [B/D, H, W, 3] of this rank's.
    ``objective`` is the rank's share of the loss (its views' mean and its
    regularizer terms, over D): its gradient, summed through the exchange's
    backward, is the gradient of ``loss``, the mean over every view of
    (1-λ)·L1 + λ·(1-SSIM) plus the pool-wide regularizers, as one device
    computes it.  ``loss`` is detached and the same on every rank."""
    D = dist.get_world_size()
    opac = torch.sigmoid(splats.opacities) * splats.alive
    sh_coeffs = torch.cat([splats.sh0, splats.shN], dim=1)
    scales = torch.exp(splats.scales)
    ps = [raster_mod.project_view(
        splats.means, splats.quats, scales, opac, sh_coeffs,
        torch.linalg.inv(c2w), K, width, height, sh_degree,
        means2d_offset=offset, camera_model=camera_model)
        for c2w, K in zip(batch["camtoworld"], batch["K"])]
    radii_max = torch.stack([p.radii for p in ps]).amax(0)
    seen = torch.stack([p.valid for p in ps]).any(0)

    bkgd = splats.means.new_zeros(3)
    losses, rgbs = [], []
    for pv, gt in zip(exchange(ps), batch["image"]):
        rgb = raster_mod.rasterize_projected(
            pv, width, height, tiles_per_gauss=tiles_per_gauss,
            tile_capacity=tile_capacity, background=bkgd).rgb
        l1 = torch.mean(torch.abs(rgb - gt))
        s = ssim_mod.ssim(rgb, gt)
        losses.append((1 - ssim_lambda) * l1 + ssim_lambda * (1 - s))
        rgbs.append(rgb)
    objective = torch.stack(losses).mean()
    if opacity_reg > 0:
        objective = objective + opacity_reg * torch.mean(
            torch.abs(torch.sigmoid(splats.opacities)) * splats.alive)
    if scale_reg > 0:
        objective = objective + scale_reg * torch.mean(
            torch.abs(scales) * splats.alive[:, None])
    objective = objective / D
    loss = objective.detach().clone()
    dist.all_reduce(loss)
    return objective, loss, radii_max, seen, torch.stack(rgbs)


def make_distributed_train_step(optimizer, width: int, height: int,
                                ssim_lambda: float = 0.2,
                                tiles_per_gauss=None,
                                tile_capacity=None,
                                opacity_reg: float = 0.0,
                                scale_reg: float = 0.0,
                                camera_model: str = "pinhole",
                                optimizer_step=None):
    """``step(splats, batch, sh_degree) -> (loss, g_offset, radii, seen)``:
    the distributed loss, one backward pass, and each rank's optimizer over
    its own shard (``optimizer_step(seen)`` in place of
    ``optimizer.step()`` where given, e.g. a learning-rate schedule or
    selective Adam).  ``batch`` as ``distributed_loss`` takes it."""

    def step(splats: Splats, batch, sh_degree: int):
        offset = torch.zeros((splats.means.shape[0], 2),
                             dtype=splats.means.dtype,
                             device=splats.means.device, requires_grad=True)
        objective, loss, radii, seen, _ = distributed_loss(
            splats, offset, batch, width, height, sh_degree, ssim_lambda,
            tiles_per_gauss, tile_capacity, opacity_reg, scale_reg,
            camera_model)
        optimizer.zero_grad(set_to_none=True)
        objective.backward()
        if optimizer_step is None:
            optimizer.step()
        else:
            optimizer_step(seen)
        return loss, offset.grad, radii, seen

    return step


# --------------------------------------------- pool-wide strategy passes

MOMENTS = ("exp_avg", "exp_avg_sq")


@torch.no_grad()
def run_on_pool(splats: Splats, optimizer, fn):
    """Run ``fn(pool, pool_optimizer)`` on the whole pool on every rank and
    keep this rank's rows: the pool and its Adam moments are all-gathered,
    ``fn`` changes them in place as it would on one device (the
    densification and relocation passes choose slots among every row), and
    each rank copies its own rows back into its shard and its moments.
    ``optimizer`` is ``splats.make_optimizer``'s (one group per field,
    named); ``fn`` must draw its random numbers the same way on every rank.
    Returns what ``fn`` returns."""
    rank = dist.get_rank()
    pool = gather_splats(splats)
    groups, state = [], {}
    for g in optimizer.param_groups:
        (p,), q = g["params"], getattr(pool, g["name"])
        st = optimizer.state.get(p)
        if st:
            state[q] = {k: gather_rows(st[k]) for k in MOMENTS}
        groups.append({"params": [q]})
    out = fn(pool, SimpleNamespace(param_groups=groups, state=state))
    n = splats.means.shape[0]
    rows = slice(rank * n, (rank + 1) * n)
    for k in FIELDS:
        getattr(splats, k).copy_(getattr(pool, k)[rows])
    for g in optimizer.param_groups:
        (p,), q = g["params"], getattr(pool, g["name"])
        st = optimizer.state.get(p)
        if st:
            for k in MOMENTS:
                st[k].copy_(state[q][k][rows])
    return out
