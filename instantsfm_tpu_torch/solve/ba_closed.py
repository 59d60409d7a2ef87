"""Bundle adjustment's system build in closed form (the BA build kernel).

A problem that declares its reprojection residual (``BlockProblem.reproj``,
set by ``problems.make_ba_problem``) on a bucketed layout is built here in
place of ``block_lm``'s ``vmap(jacfwd)`` path.  Per row, at delta = 0:

    xyz = M(q) X + t                 M(q): q's rotation matrix
    d xyz / d(w, dt, dX) = (-[xyz]x, I, M(q))   (first-order pose action)
    (u, v) = xyz[:2] / (z + EPS)     EPS = scene.cameras._EPS
    proj = K(distort(u, v))          with d proj / d(u, v) and d proj / d
                                     (the optimised intrinsics)
    r = proj - (x, y),  s = |r|^2,  w = rho'(s), loss = rho(s)  (0 where
                                     the row is invalid)

then the whitening by sqrt(w), the per-row products W = Jcᵀ Jp (kept),
U_o = Jcᵀ Jc, V_o = Jpᵀ Jp, gc = -Jcᵀ r, gp = -Jpᵀ r, and their sums by
camera (U, g_cam) and by point (V, g_pt).  The residual's value and its
Jacobian are those of ``problems.make_ba_problem``'s ``residual_fn``;
``rho`` is Huber's (``robust.huber``, the kernel every BA caller passes,
``pipeline/ba.py``).

Camera models covered (``MODELS``), those of the databases the port's
entry points write: SIMPLE_PINHOLE (``cli.feat``'s own front ends,
``features/handler.py::generate_database``), SIMPLE_RADIAL (its
``feature_name="colmap"`` passthrough to COLMAP's feature extractor, and
the ring scenes, ``bench_e2e_torch.write_ring_db``), with poses free
(PC = 6 + intrinsics) or frozen (PC = the intrinsics).  Any other
model or robust kernel keeps ``block_lm``'s autodiff build (``covers``).

``build`` and ``loss_vec`` dispatch on the device of their inputs, as
``schur_wchain`` does: CPU tensors go to the plain torch version
(``build_reference``, ``loss_vec_reference``: the formulas above, one row
per element, the sums through ``index_add_`` and ``blocked.seg_by_pt``),
CUDA tensors to the hand-written kernel ``csrc/ba_build.cu`` (built with
nvcc on first use, launched on the current stream): one launch writes W,
the per-row loss and the camera and point sums, and its loss mode writes
the per-row loss alone; ``LAUNCHES`` counts both.  A kernel that fails to
build or launch raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.scene import cameras as cm
from instantsfm_tpu_torch.solve.blocked import seg_by_pt
from instantsfm_tpu_torch.solve.schur_wchain import (SHARED_TABLE_BYTES,
                                                     tiled_table)
from instantsfm_tpu_torch.utils import build as _build

MODELS = (cm.SIMPLE_PINHOLE, cm.SIMPLE_RADIAL)
# the kernel's launches on CUDA tensors: "build" and its loss mode "loss"
LAUNCHES = {"build": 0, "loss": 0}


def covers(problem, kernel, buckets) -> bool:
    """Whether ``problem``'s system is built here: it declares its
    reprojection residual on a covered camera model, the robust kernel is
    Huber's, and the layout is bucketed."""
    return (bool(buckets) and problem.reproj is not None
            and problem.reproj[0] in MODELS and kernel.kind[:1] == ("huber",))


def _distort_project(model_id, intr, u, v):
    """Pixel coordinates of the z = 1 plane point (u, v) [O], with
    d proj / d(u, v) [O, 2, 2] and d proj / d(the optimised intrinsics)
    [O, 2, NI], as ``cameras.img_from_plane`` and its derivatives."""
    if model_id == cm.SIMPLE_RADIAL:
        f, cx, cy, k = intr[:, 0], intr[:, 1], intr[:, 2], intr[:, 3]
        r2 = u * u + v * v
        radial = k * r2
        ud, vd = u + u * radial, v + v * radial
        a, b = 1.0 + radial, 2.0 * k                # b: 2 d radial / d r2
        Jd = torch.stack([a + b * u * u, b * u * v,
                          b * u * v, a + b * v * v], -1).reshape(-1, 2, 2)
        Jd = Jd * f[:, None, None]
        Ji = torch.stack([ud, f * u * r2, vd, f * v * r2], -1)
        proj = torch.stack([ud * f + cx, vd * f + cy], -1)
        return proj, Jd, Ji.reshape(u.shape[0], 2, 2)
    if model_id == cm.SIMPLE_PINHOLE:
        f = intr[:, 0]
        zero = torch.zeros_like(u)
        proj = torch.stack([u * f + intr[:, 1], v * f + intr[:, 2]], -1)
        Jd = torch.stack([f, zero, zero, f], -1).reshape(-1, 2, 2)
        return proj, Jd, torch.stack([u, v], -1)[:, :, None]
    raise ValueError(f"camera model {model_id} has no closed form here")


def rows_reference(model_id, optimize_poses, q, t, intr, X, xy,
                   jacobians=True):
    """Per-row residual r [O, 2], and with ``jacobians`` Jc [O, 2, PC] and
    Jp [O, 2, 3], of cameras (q [O, 4], t [O, 3], intr [O, P]) and points
    X [O, 3] gathered per row, against keypoints xy [O, 2]."""
    M = lie.quat_to_matrix(q)                                   # [O, 3, 3]
    xyz = torch.sum(M * X[:, None, :], dim=-1) + t
    zi = 1.0 / (xyz[:, 2] + cm._EPS)
    u, v = xyz[:, 0] * zi, xyz[:, 1] * zi
    proj, Jd, Ji = _distort_project(model_id, intr, u, v)
    r = proj - xy
    if not jacobians:
        return r
    # d proj / d xyz = Jd @ d(u, v) / d xyz
    zc = zi[:, None]
    Jx = torch.stack([Jd[:, :, 0] * zc, Jd[:, :, 1] * zc,
                      -(Jd[:, :, 0] * u[:, None] + Jd[:, :, 1] * v[:, None])
                      * zc], -1)                                 # [O, 2, 3]
    Jp = torch.sum(Jx[:, :, :, None] * M[:, None, :, :], dim=2)  # [O, 2, 3]
    if optimize_poses:
        # d/dw of w x xyz is -[xyz]x: row a of it is xyz x Jx[a]
        Jrot = torch.linalg.cross(xyz[:, None, :].expand_as(Jx), Jx, dim=-1)
        Jc = torch.cat([Jrot, Jx, Ji], dim=-1)
    else:
        Jc = Ji
    return r, Jc, Jp


def gathered(params, obs):
    """The rows' operands of ``rows_reference``: (q, t, intr, X, xy)."""
    cam, ci = params.cam, obs.cam_idx
    xy = torch.stack([obs.data["x"], obs.data["y"]], dim=-1)
    return cam["q"][ci], cam["t"][ci], cam["intr"][ci], \
        params.pts[obs.pt_idx], xy


def _masked(kernel, s, valid):
    zs = torch.zeros_like(s)
    return (torch.where(valid, kernel.weight(s), zs),
            torch.where(valid, kernel.loss(s), zs))


def loss_vec_reference(problem, params, obs, kernel):
    """Plain version of the loss mode: rho(|r_o|^2), 0 on invalid rows."""
    model_id, optimize_poses = problem.reproj
    r = rows_reference(model_id, optimize_poses, *gathered(params, obs),
                       jacobians=False)
    return _masked(kernel, torch.sum(r * r, dim=-1), obs.valid)[1]


def row_products(kernel, valid, r, Jc, Jp):
    """Per row, of the residual r [O, 2] and Jacobians Jc [O, 2, PC], Jp
    [O, 2, 3] whitened by sqrt(w): (the camera entries [O, PC*PC + PC],
    U_o row-major then g_c; V_o [O, 3, 3]; gp_o [O, 3]; W [O, PC, 3];
    loss_vec [O])."""
    O, PC = Jc.shape[0], Jc.shape[2]
    w, loss_vec = _masked(kernel, torch.sum(r * r, dim=-1), valid)
    sw = torch.sqrt(w)[:, None]
    r = r * sw
    Jc = Jc * sw[..., None]
    Jp = Jp * sw[..., None]
    U_o = torch.sum(Jc[:, :, :, None] * Jc[:, :, None, :], 1)    # [O, PC, PC]
    V_o = torch.sum(Jp[:, :, :, None] * Jp[:, :, None, :], 1)    # [O, 3, 3]
    W = torch.sum(Jc[:, :, :, None] * Jp[:, :, None, :], 1)      # [O, PC, 3]
    gc_o = -torch.sum(Jc * r[:, :, None], dim=1)                 # [O, PC]
    gp_o = -torch.sum(Jp * r[:, :, None], dim=1)                 # [O, 3]
    return (torch.cat([U_o.reshape(O, PC * PC), gc_o], dim=1), V_o, gp_o,
            W, loss_vec)


def build_reference(problem, params, obs, kernel, num_points, buckets):
    """Plain version of the build: (Ug [C, PC*PC + PC] the camera sums of
    U_o and g_c side by side, V [T, 3, 3], g_pt [T, 3], W [O, PC, 3],
    loss_vec [O]), each over this process's rows."""
    model_id, optimize_poses = problem.reproj
    C = params.cam["q"].shape[0]
    r, Jc, Jp = rows_reference(model_id, optimize_poses,
                               *gathered(params, obs))
    rows, V_o, gp_o, W, loss_vec = row_products(kernel, obs.valid, r, Jc, Jp)
    Ug = rows.new_zeros((C, rows.shape[1])).index_add_(0, obs.cam_idx, rows)
    return (Ug, seg_by_pt(V_o, buckets, num_points),
            seg_by_pt(gp_o, buckets, num_points), W, loss_vec)


# ------------------------------------------------------------ the kernel

BLOCK = 256       # threads per block and rows per work item (csrc/ba_build.cu)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def shared_table(C, PC, dtype) -> bool:
    """Whether the kernel keeps its cameras in shared memory and sums them
    there (else each row reads its camera through L1 and adds to the
    output with global atomics): the two tables a block holds fit in K1's
    budget for its own table (``schur_wchain.SHARED_TABLE_BYTES``, 96 KB),
    the sums' (a camera's upper triangle of U_o and its g_c,
    PC (PC + 1) / 2 + PC entries packed in 16-byte words) and the
    cameras' (M(q), t and at most 4 parameters, 16 entries a camera).
    At PC = 8 that is C <= 409 in float32 and 204 in float64; at PC = 2,
    1,024 and 558."""
    size = torch.finfo(dtype).bits // 8
    words = -(-(PC * (PC + 1) // 2 + PC) // (16 // size))
    return C * (words * 16 + 16 * size) <= SHARED_TABLE_BYTES


@lru_cache(maxsize=None)
def _lib():
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load("ba_build")
    p, i, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_double)
    lib.ba_build_launch.argtypes = [
        i, i, i, i, d,            # dtype, model, poses, shared, Huber's delta
        p, p, p, i, p,            # q, t, intr, intr stride, pts
        p, p, p, p,               # x, y, valid, cam_idx
        p, p, p, p, p,            # W, loss, Ug, V, g_pt
        i,                        # cameras C
        i, p, p, p, p, p,         # nb, row_start, rows, pt_start, log_l, item_off
        p]                        # stream
    lib.ba_build_launch.restype = ctypes.c_int
    lib.ba_loss_launch.argtypes = [
        i, i, d,                  # dtype, model, Huber's delta
        p, p, p, i, p,            # q, t, intr, intr stride, pts
        p, p, p, p, p,            # x, y, valid, cam_idx, pt_idx
        p, ll, p]                 # loss, rows O', stream
    lib.ba_loss_launch.restype = ctypes.c_int
    lib.ba_build_error_string.argtypes = [ctypes.c_int]
    lib.ba_build_error_string.restype = ctypes.c_char_p
    return lib


def _operands(problem, params, obs, kernel):
    """The kernel's inputs, checked: ((dtype code, model, poses, Huber's
    delta), (q, t, intr, pts, x, y, valid, cam_idx, pt_idx))."""
    model_id, optimize_poses = problem.reproj
    pts = params.pts
    dt = pts.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"ba_build kernel takes float32/float64, got {dt}")
    q, t, intr = (params.cam[k].contiguous() for k in ("q", "t", "intr"))
    x, y = (obs.data[k].contiguous() for k in ("x", "y"))
    O = obs.valid.shape[0]
    C = q.shape[0]
    for name, a, shape in (("q", q, (C, 4)), ("t", t, (C, 3)),
                           ("pts", pts, (pts.shape[0], 3)),
                           ("x", x, (O,)), ("y", y, (O,))):
        if a.dtype != dt:
            raise TypeError(f"{name} is {a.dtype}, pts is {dt}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    n_par = cm.get_camera_model_info(model_id)["num_params"]
    if intr.dtype != dt or intr.dim() != 2 or intr.shape[0] != C \
            or intr.shape[1] < n_par:
        raise ValueError(f"intr {intr.dtype} {tuple(intr.shape)} does not "
                         f"hold model {model_id}'s parameters for {C} cameras")
    if obs.cam_idx.dtype != torch.int32 or obs.pt_idx.dtype != torch.int32:
        raise TypeError("cam_idx and pt_idx must be int32")
    if obs.valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {obs.valid.dtype}")
    if model_id not in MODELS or kernel.kind[:1] != ("huber",):
        raise ValueError(f"no closed form of model {model_id} with robust "
                         f"kernel {kernel.kind}")
    ops = (q, t, intr, pts.contiguous(), x, y, obs.valid.contiguous(),
           obs.cam_idx.contiguous(), obs.pt_idx.contiguous())
    if any(a.device != pts.device for a in ops):
        raise ValueError("ba_build inputs live on different devices")
    return (_DTYPE_CODE[dt], model_id, int(optimize_poses),
            float(kernel.kind[1])), ops


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check(err):
    if err != 0:
        raise RuntimeError("ba_build kernel launch failed: "
                           + _lib().ba_build_error_string(err).decode())


def _launch_build(problem, params, obs, kernel, num_points, buckets):
    codes, (q, t, intr, pts, x, y, valid, cam_idx, _) = _operands(
        problem, params, obs, kernel)
    PC = problem.cam_dim
    C, O = q.shape[0], valid.shape[0]
    if num_points != pts.shape[0]:
        raise ValueError(f"num_points {num_points} is not the {pts.shape[0]} "
                         "point slots")
    row_start, rows, pt_start, log_l, item_off = tiled_table(buckets, O,
                                                             num_points)
    dev, dt = pts.device, pts.dtype
    W = torch.empty((O, PC, 3), dtype=dt, device=dev)
    loss = torch.empty((O,), dtype=dt, device=dev)
    Ug = torch.empty((C, PC * PC + PC), dtype=dt, device=dev)
    V = torch.empty((num_points, 3, 3), dtype=dt, device=dev)
    g_pt = torch.empty((num_points, 3), dtype=dt, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.ba_build_launch(
            codes[0], codes[1], codes[2], int(shared_table(C, PC, dt)),
            codes[3],
            q.data_ptr(), t.data_ptr(), intr.data_ptr(), intr.shape[1],
            pts.data_ptr(), x.data_ptr(), y.data_ptr(), valid.data_ptr(),
            cam_idx.data_ptr(), W.data_ptr(), loss.data_ptr(), Ug.data_ptr(),
            V.data_ptr(), g_pt.data_ptr(), C,
            len(row_start), row_start.ctypes.data, rows.ctypes.data,
            pt_start.ctypes.data, log_l.ctypes.data, item_off.ctypes.data,
            _stream(dev))
    _check(err)
    LAUNCHES["build"] += 1
    return Ug, V, g_pt, W, loss


def _launch_loss(problem, params, obs, kernel):
    codes, (q, t, intr, pts, x, y, valid, cam_idx, pt_idx) = _operands(
        problem, params, obs, kernel)
    O = valid.shape[0]
    loss = torch.empty((O,), dtype=pts.dtype, device=pts.device)
    with torch.cuda.device(pts.device):
        err = _lib().ba_loss_launch(
            codes[0], codes[1], codes[3], q.data_ptr(),
            t.data_ptr(), intr.data_ptr(), intr.shape[1], pts.data_ptr(),
            x.data_ptr(), y.data_ptr(), valid.data_ptr(), cam_idx.data_ptr(),
            pt_idx.data_ptr(), loss.data_ptr(), O, _stream(pts.device))
    _check(err)
    LAUNCHES["loss"] += 1
    return loss


def _device_type(params):
    dev = params.pts.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ba_closed: unsupported device {dev}")
    return dev.type


def build(problem, params, obs, kernel, num_points, buckets):
    """(Ug, V, g_pt, W, loss_vec) of ``build_reference`` over this
    process's rows: the plain version on CPU tensors, one kernel launch
    (counted in ``LAUNCHES["build"]``) on CUDA tensors."""
    if _device_type(params) == "cpu":
        return build_reference(problem, params, obs, kernel, num_points,
                               buckets)
    return _launch_build(problem, params, obs, kernel, num_points, buckets)


def loss_vec(problem, params, obs, kernel):
    """Per-row robust loss: the plain version on CPU tensors, the kernel's
    loss mode (counted in ``LAUNCHES["loss"]``) on CUDA tensors."""
    if _device_type(params) == "cpu":
        return loss_vec_reference(problem, params, obs, kernel)
    return _launch_loss(problem, params, obs, kernel)
