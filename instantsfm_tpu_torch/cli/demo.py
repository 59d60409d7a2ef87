"""Web demo: upload images -> features -> SfM -> interactive 3D view
(reference ``demo.py``: gradio Blocks + plotly figure).

Counterpart of ``instantsfm_tpu/cli/demo.py``:

    python -m instantsfm_tpu_torch.cli.demo --data_path SCENE [--device cuda|cpu]
    python -m instantsfm_tpu_torch.cli.demo --serve

gradio is optional; without it the same pipeline runs as a one-shot CLI
that writes ``SCENE/view.html``, a self-contained canvas scatter of the
points and camera centres.  Features and SfM run on ``--device`` (the card
unless ``--device cpu``)."""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def run_pipeline(input_path: str, log=print, device="cuda") -> str:
    """feat + sfm over a folder with images/ (reference ``run_sfm``)."""
    from instantsfm_tpu_torch.cli import feat as feat_cli
    from instantsfm_tpu_torch.cli import sfm as sfm_cli

    dev = ["--device", str(device)]
    feat_cli.main(["--data_path", input_path] + dev)
    rc = sfm_cli.main(["--data_path", input_path] + dev)
    if rc != 0:
        raise RuntimeError("sfm failed")
    return os.path.join(input_path, "sparse", "0")


def _scene_payload(sparse_dir: str, device="cuda") -> dict:
    """Points, colours and camera centres (in torch on ``device``) of a
    sparse model, as JSON lists."""
    import torch

    from instantsfm_tpu_torch.io import colmap_model as cmio
    from instantsfm_tpu_torch.math import lie
    from instantsfm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cams, imgs, pts = cmio.read_model(sparse_dir)
    xyz = np.stack([p.xyz for p in pts.values()]) if pts else np.zeros((0, 3))
    rgb = np.stack([p.rgb for p in pts.values()]) if pts else np.zeros((0, 3))
    q = np.array([[x, y, z, w] for w, x, y, z in
                  (im.qvec_wxyz for im in imgs.values())], np.float64)
    t = np.array([im.tvec for im in imgs.values()], np.float64)
    centers = lie.camera_center(
        torch.as_tensor(q.reshape(-1, 4), device=dev),
        torch.as_tensor(t.reshape(-1, 3), device=dev)).cpu().numpy()
    return {"points": xyz.tolist(), "colors": rgb.tolist(),
            "cameras": centers.tolist()}


def write_html_view(sparse_dir: str, out_html: str, device="cuda") -> str:
    """Self-contained rotating-scatter HTML view (plotly-free fallback)."""
    payload = _scene_payload(sparse_dir, device=device)
    html = """<!DOCTYPE html><html><head><meta charset="utf-8">
<style>body{margin:0;background:#111}canvas{display:block}</style></head>
<body><canvas id="c"></canvas><script>
const data = %s;
const cv = document.getElementById('c'); const ctx = cv.getContext('2d');
cv.width = innerWidth; cv.height = innerHeight;
let angle = 0;
function draw(){
  ctx.fillStyle='#111'; ctx.fillRect(0,0,cv.width,cv.height);
  const ca=Math.cos(angle), sa=Math.sin(angle), s=Math.min(cv.width,cv.height)/8;
  function proj(p){const x=p[0]*ca+p[1]*sa, y=-p[0]*sa*0.3+p[1]*ca*0.3+p[2];
    return [cv.width/2+x*s, cv.height/2-y*s];}
  data.points.forEach((p,i)=>{const q=proj(p);
    const c=data.colors[i]||[128,128,128];
    ctx.fillStyle=`rgb(${c[0]},${c[1]},${c[2]})`;
    ctx.fillRect(q[0],q[1],2,2);});
  data.cameras.forEach(p=>{const q=proj(p);ctx.fillStyle='#f33';
    ctx.fillRect(q[0]-3,q[1]-3,6,6);});
  angle+=0.005; requestAnimationFrame(draw);}
draw();
</script></body></html>""" % json.dumps(payload)
    with open(out_html, "w") as f:
        f.write(html)
    return out_html


def launch_gradio(device="cuda"):
    import gradio as gr

    def process_folder(folder):
        sparse = run_pipeline(folder, device=device)
        html = write_html_view(sparse, os.path.join(folder, "view.html"),
                               device=device)
        with open(html) as f:
            return f.read()

    with gr.Blocks(title="InstantSfM demo (PyTorch/CUDA)") as demo:
        gr.Markdown("# InstantSfM (PyTorch/CUDA)\nFolder with `images/` -> "
                    "sparse reconstruction")
        inp = gr.Textbox(label="dataset folder")
        btn = gr.Button("Reconstruct")
        out = gr.HTML()
        btn.click(process_folder, inp, out)
    demo.launch()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", default=None,
                        help="run headless on this folder")
    parser.add_argument("--serve", action="store_true",
                        help="launch the gradio UI (requires gradio)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.serve:
        try:
            launch_gradio(args.device)
        except ImportError:
            print("gradio is not installed; use --data_path for headless mode",
                  file=sys.stderr)
            return 1
        return 0
    if not args.data_path:
        print("need --data_path or --serve", file=sys.stderr)
        return 1
    sparse = run_pipeline(args.data_path, device=args.device)
    html = write_html_view(sparse, os.path.join(args.data_path, "view.html"),
                           device=args.device)
    print(f"interactive view written to {html}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
