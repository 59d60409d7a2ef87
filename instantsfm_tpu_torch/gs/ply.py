"""3DGS checkpoint -> .ply exporter (reference ``vis/extract_ply.py``).

Counterpart of ``instantsfm_tpu/gs/ply.py``; writes the same bytes.

Writes the standard "gaussian splatting PLY" layout (x,y,z, nx,ny,nz, f_dc_*,
f_rest_*, opacity, scale_*, rot_*) without the plyfile dependency — binary
little-endian PLY emitted directly.
"""

from __future__ import annotations

import numpy as np


def export_ply(path: str, means, scales_log, quats_xyzw, opacities_logit,
               sh0, shN, alive=None) -> str:
    means = np.asarray(means)
    if alive is not None:
        alive = np.asarray(alive).astype(bool)
        means = means[alive]
        scales_log = np.asarray(scales_log)[alive]
        quats_xyzw = np.asarray(quats_xyzw)[alive]
        opacities_logit = np.asarray(opacities_logit)[alive]
        sh0 = np.asarray(sh0)[alive]
        shN = np.asarray(shN)[alive]
    n = len(means)
    sh0 = np.asarray(sh0).reshape(n, -1)          # [n, 3]
    shN = np.asarray(shN).reshape(n, -1)          # [n, 3*(K-1)] channel-major?
    # gaussian-splatting convention stores f_rest as [K-1, 3] transposed to
    # channel-major: (3, K-1) flattened
    k1 = shN.shape[1] // 3
    shN_cm = np.asarray(shN).reshape(n, k1, 3).transpose(0, 2, 1).reshape(n, -1)
    # wxyz rotation convention in the splat PLY
    q = np.asarray(quats_xyzw)
    rot = np.stack([q[:, 3], q[:, 0], q[:, 1], q[:, 2]], -1)

    fields = (["x", "y", "z", "nx", "ny", "nz"]
              + [f"f_dc_{i}" for i in range(3)]
              + [f"f_rest_{i}" for i in range(shN_cm.shape[1])]
              + ["opacity"]
              + [f"scale_{i}" for i in range(3)]
              + [f"rot_{i}" for i in range(4)])
    data = np.concatenate([
        means, np.zeros((n, 3), np.float32), sh0, shN_cm,
        np.asarray(opacities_logit).reshape(n, 1),
        np.asarray(scales_log), rot], axis=1).astype("<f4")

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {f}" for f in fields]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())
    return path


def export_ply_from_checkpoint(ckpt_path: str, out_path: str) -> str:
    z = np.load(ckpt_path)
    return export_ply(out_path, z["means"], z["scales"], z["quats"],
                      z["opacities"], z["sh0"], z["shN"], z.get("alive"))
