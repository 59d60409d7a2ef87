"""Card-only tests of the port: the CUDA kernels against their plain torch
versions, and the BA stage on the card against the same stage on the CPU.

This file imports neither JAX nor the JAX package, so on the card machine
(which has no JAX) it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Without a card each test skips.  Tolerances: float64 rtol 1e-10 (the kernel
sums each track by a butterfly, the plain version by a reshape-sum); float32
rtol 1e-4 with atol 1e-5 * max|u| (float32 sums of up to 2048 products)."""

import numpy as np
import pytest
import torch

from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.solve.blocked import bucketize


def mixed_layout(lengths, C, PC, seed):
    """Bucketized layout with the given track lengths, plus random W (zero
    on padded rows), SPD V_inv and x, as numpy arrays."""
    rng = np.random.default_rng(seed)
    pt = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    O = len(pt)
    cam = rng.integers(0, C, O).astype(np.int32)
    bp = bucketize(cam, pt, {}, np.ones(O, bool), np.zeros((O, 1)),
                   np.zeros(O, bool), len(lengths), track_pad=4)
    Op, T = len(bp.cam_idx), bp.num_slots
    W = rng.standard_normal((Op, PC, 3)) * bp.valid[:, None, None]
    A = rng.standard_normal((T, 3, 3))
    V_inv = A @ A.transpose(0, 2, 1) + np.eye(3)
    x = rng.standard_normal((C, PC))
    return W, V_inv, x, bp.cam_idx, bp.pt_idx, bp.buckets


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("PC", [3, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_schur_wchain_kernel_matches_reference(PC, dtype):
    _need_card()
    dt = getattr(torch, dtype)
    rtol = 1e-4 if dt == torch.float32 else 1e-10
    lengths = [2, 8, 32, 64, 512, 2048, 3, 17, 100, 1000] * 20
    W, V_inv, x, cam_idx, pt_idx, buckets = mixed_layout(lengths, 50, PC, 1)
    args = [torch.tensor(a, device="cuda", dtype=dt) for a in (W, V_inv, x)]
    idx = [torch.tensor(a, device="cuda") for a in (cam_idx, pt_idx)]
    want = k1.schur_wchain_reference(*args, *idx, buckets)
    before = k1.schur_wchain.launches
    got = k1.schur_wchain(*args, *idx, buckets)
    torch.cuda.synchronize()
    assert k1.schur_wchain.launches == before + 1
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * 0.1 * scale)
    assert torch.all(got[torch.tensor(~np.any(W != 0, axis=(1, 2)),
                                      device="cuda")] == 0)


@pytest.mark.cuda
def test_schur_wchain_kernel_rejects_bad_inputs():
    _need_card()
    W, V_inv, x, cam_idx, pt_idx, buckets = mixed_layout([4] * 64, 5, 8, 2)
    args = [torch.tensor(a, device="cuda", dtype=torch.float32)
            for a in (W, V_inv, x)]
    idx = [torch.tensor(a, device="cuda") for a in (cam_idx, pt_idx)]
    with pytest.raises(ValueError):
        k1.schur_wchain(*args, *idx, ())              # no bucketed layout
    with pytest.raises(TypeError):
        k1.schur_wchain(*args, idx[0].long(), idx[1], buckets)
    with pytest.raises(TypeError):
        k1.schur_wchain(args[0].double(), *args[1:], *idx, buckets)


@pytest.mark.cuda
def test_bundle_adjustment_rounds_card_matches_cpu():
    """The whole BA stage in float64 on the card (K1 in every PCG matvec,
    index_add_ atomics) against the same stage on the CPU: poses agree to
    1e-6, the LM iteration count of each round within one."""
    _need_card()
    import chip_smoke
    from instantsfm_tpu_torch import config
    from instantsfm_tpu_torch.pipeline import ba
    from instantsfm_tpu_torch.utils import debug

    opts = dict(config.BUNDLE_ADJUSTER_OPTIONS, max_num_iterations=10)
    out = {}
    for device in ("cpu", "cuda"):
        cameras, images, tracks, _ = chip_smoke.make_scene(num_cams=20,
                                                           num_pts=9000)
        debug.drain_stats()
        launches = k1.schur_wchain.launches
        ba.bundle_adjustment_rounds(cameras, images, tracks, opts, 1e-2,
                                    device=device)
        out[device] = (images, debug.drain_stats()["ba_lm_iters"],
                       k1.schur_wchain.launches - launches)
    (img_c, it_c, _), (img_g, it_g, n_launch) = out["cpu"], out["cuda"]
    assert n_launch > 0
    assert all(abs(a - b) <= 1 for a, b in zip(it_c, it_g)), (it_c, it_g)
    np.testing.assert_allclose(img_g.qvec, img_c.qvec, atol=1e-6)
    np.testing.assert_allclose(img_g.tvec, img_c.tvec, atol=1e-6)
