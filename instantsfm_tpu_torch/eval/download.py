"""Benchmark dataset downloader (reference ``eval/colmap_eval/download.py``).

Counterpart of ``instantsfm_tpu/eval/download.py``, the same files and
layout.

Egress-gated: on a machine without network access every download attempt
fails fast with the exact URLs/commands to run elsewhere.
File lists mirror the reference's so a directory populated by either tool
has the same layout (``eval/datasets.py`` conventions).

Usage:
    python -m instantsfm_tpu_torch.eval.download --data_path <dir> \
        --datasets eth3d blended_mvs
"""

from __future__ import annotations

import argparse
import os

ETH3D_FILES = [
    ("multi_view_training_dslr_undistorted.7z", "dslr"),
    ("multi_view_test_dslr_undistorted.7z", "dslr"),
    ("multi_view_training_rig_undistorted.7z", "rig"),
    ("multi_view_test_rig_undistorted.7z", "rig"),
]
ETH3D_BASE = "https://www.eth3d.net/data/"

BLENDED_MVS_BASE = ("https://github.com/YoYo000/BlendedMVS/releases/"
                    "download/v1.0.0/")
BLENDED_MVS_FILES = ["BlendedMVS.zip"] + [f"BlendedMVS.z{i:02d}"
                                          for i in range(1, 16)]

IMC_KAGGLE = {
    "imc2023": "image-matching-challenge-2023",
    "imc2024": "image-matching-challenge-2024",
}


def _fetch(url: str, target: str) -> str:
    """Download one file; raises a helpful error when offline."""
    import urllib.error
    import urllib.request

    os.makedirs(target, exist_ok=True)
    name = url.rsplit("/", 1)[-1]
    out = os.path.join(target, name)
    try:
        urllib.request.urlretrieve(url, out)
    except (urllib.error.URLError, OSError) as e:
        raise RuntimeError(
            f"download failed, no network egress? ({e}); fetch manually:\n"
            f"    curl -LO {url}\nand place the file at {out}") from e
    return out


def _extract(archive: str, target: str) -> None:
    if archive.endswith(".7z"):
        try:
            import py7zr
        except ImportError as e:
            raise RuntimeError(
                f"extracting {archive} needs py7zr (not installed); "
                f"run `7z x {archive}` manually") from e
        with py7zr.SevenZipFile(archive, mode="r") as a:
            a.extractall(path=target)
    elif archive.endswith(".zip"):
        import zipfile
        with zipfile.ZipFile(archive) as a:
            a.extractall(path=target)


def download_eth3d(data_path: str) -> None:
    for filename, category in ETH3D_FILES:
        target = os.path.join(data_path, "eth3d", category)
        archive = _fetch(ETH3D_BASE + filename, target)
        _extract(archive, target)


def download_blended_mvs(data_path: str) -> None:
    target = os.path.join(data_path, "blended_mvs")
    for filename in BLENDED_MVS_FILES:
        _fetch(BLENDED_MVS_BASE + filename, target)
    _extract(os.path.join(target, "BlendedMVS.zip"), target)


def download_imc(data_path: str, name: str) -> None:
    import shutil
    import subprocess

    target = os.path.join(data_path, name)
    os.makedirs(target, exist_ok=True)
    if shutil.which("kaggle") is None:
        raise RuntimeError(
            f"IMC downloads need the kaggle CLI; run elsewhere:\n"
            f"    kaggle competitions download -c {IMC_KAGGLE[name]} "
            f"-p {target}")
    subprocess.check_call(["kaggle", "competitions", "download", "-c",
                           IMC_KAGGLE[name], "-p", target])
    _extract(os.path.join(target, IMC_KAGGLE[name] + ".zip"), target)


DOWNLOADERS = {
    "eth3d": download_eth3d,
    "blended_mvs": download_blended_mvs,
    "imc2023": lambda p: download_imc(p, "imc2023"),
    "imc2024": lambda p: download_imc(p, "imc2024"),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--datasets", nargs="+", default=list(DOWNLOADERS),
                        choices=list(DOWNLOADERS))
    args = parser.parse_args(argv)
    for d in args.datasets:
        DOWNLOADERS[d](args.data_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
