"""Time other builds of the 3DGS compositing kernels K2/K3 beside this
checkout's, on one CUDA card, at the 3DGS main shape of ``chip_smoke.py``.

Run from the repository root:

    python3 compare_composite_builds.py OTHER.cu [OTHER.cu ...]

Each OTHER.cu is a version of ``instantsfm_tpu_torch/csrc/composite_tiles.cu``
with the same C interface: an earlier commit's (``git show
<commit>:instantsfm_tpu_torch/csrc/composite_tiles.cu``), or a variant that
leaves out one part of the design to measure what that part costs.  Each is
built with ``nvcc`` and the port's flags into a temporary directory, then
run on the same inputs as this checkout's kernels: one training view of the
model that ``chip_smoke.run_gs`` trains (1,900 tiles, K = 512), and K3 on
this build's logt.  For each build it prints one ``COMPARE`` line: the
largest difference from this build's outputs, relative to each output
group's (K2) or gradient column's (K3) max, whether K2 entered the same
chunks, the registers and spills ptxas reports, and cold-L2 times
(``chip_smoke.time_ms``) in the order other, this, this, other.  Launches
made here go around the wrappers and are not counted.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs
from instantsfm_tpu_torch.gs import composite as k23
from instantsfm_tpu_torch.utils import build

REPS = 20


def build_libs(sources, out_dir):
    """Compile every source at once (one nvcc each) and load them:
    [(source, CDLL, ptxas register/spill lines)]."""
    procs = []
    for i, src in enumerate(sources):
        so = os.path.join(out_dir, f"libother{i}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", so, src]
        procs.append((src, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for src, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.composite_fwd_launch.argtypes = [p, p, i, i, i, p, p, p]
        lib.composite_bwd_launch.argtypes = [p, p, p, i, i, i, p, p]
        libs.append((src, lib, [ln.strip() for ln in log.splitlines()
                                if "Used" in ln or "spill" in ln]))
    return libs


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def compare(src, lib, ptxas, attrs, nchunks, ntx):
    n, K, _ = attrs.shape
    dev = attrs.device
    out = torch.empty((n, 8, k23.P), device=dev)
    logt = torch.empty((n, K // k23.CHUNK, k23.P), device=dev)
    g_attrs = torch.empty_like(attrs)
    gout = torch.randn((n, 8, k23.P), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(cs.SEED))
    this_out, this_logt = k23.composite_fwd(attrs, nchunks, ntx)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def other_fwd():
        if lib.composite_fwd_launch(attrs.data_ptr(), nchunks.data_ptr(), n,
                                    K, ntx, out.data_ptr(), logt.data_ptr(),
                                    stream):
            raise RuntimeError(f"{src}: K2 launch failed")

    def other_bwd():
        if lib.composite_bwd_launch(attrs.data_ptr(), gout.data_ptr(),
                                    this_logt.data_ptr(), n, K, ntx,
                                    g_attrs.data_ptr(), stream):
            raise RuntimeError(f"{src}: K3 launch failed")

    other_fwd()
    other_bwd()
    this_g = k23.composite_bwd(attrs, this_logt, gout, ntx)
    torch.cuda.synchronize()
    rec = dict(source=src, tiles=n, K=K, ptxas=ptxas,
               k2_same_chunks=bool(torch.equal(cs.entered(logt),
                                               cs.entered(this_logt))),
               k2_max_rel_err=max(rel_err(out[:, r], this_out[:, r])
                                  for r in (slice(0, 3), slice(3, 4),
                                            slice(4, 5))),
               k3_max_rel_err=max(rel_err(g_attrs[..., c], this_g[..., c])
                                  for c in range(10)))
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    for kname, other, this in (
            ("k2", other_fwd, lambda: k23.composite_fwd(attrs, nchunks, ntx)),
            ("k3", other_bwd,
             lambda: k23.composite_bwd(attrs, this_logt, gout, ntx))):
        times = [(who, cs.time_ms(fn, REPS, flush)) for who, fn in
                 (("other", other), ("this", this), ("this", this),
                  ("other", other))]
        rec[f"{kname}_order"] = [who for who, _ in times]
        rec[f"{kname}_ms"] = [t for _, t in times]
    cs.log("COMPARE " + json.dumps(rec))


def main(argv=None):
    sources = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("compare_composite_builds: no CUDA device available",
              file=sys.stderr)
        return 1
    if not sources:
        print(__doc__, file=sys.stderr)
        return 2
    # the model chip_smoke.py trains: full-precision float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"card: {cs.card_line()}")
    build.build_all(["composite_tiles"])
    with tempfile.TemporaryDirectory(prefix="composite_builds_") as tmp:
        libs = build_libs(sources, tmp)
        _, tiles = cs.run_gs(torch.device("cuda"))
        for src, lib, ptxas in libs:
            compare(src, lib, ptxas, *tiles)
    return 0


if __name__ == "__main__":
    sys.exit(main())
