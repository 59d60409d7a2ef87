"""Training-scalar logging (reference tensorboard usage,
``vis/gsplat_trainer.py:313,708-723``); counterpart of
``instantsfm_tpu/utils/scalars.py``.

Always writes an append-only JSONL stream (``scalars.jsonl`` — trivially
greppable/plottable, works offline); additionally mirrors into a real
tensorboard ``SummaryWriter`` when the package is importable.
"""

from __future__ import annotations

import json
import os

import numpy as np

from instantsfm_tpu_torch.io.image import imwrite


class ScalarLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_image(self, tag: str, img, step: int) -> None:
        """img: [H, W, 3] float in [0, 1]; JSONL records the saved path."""
        path = os.path.join(os.path.dirname(self._jsonl.name),
                            f"{tag.replace('/', '_')}_{step:06d}.png")
        imwrite(path, (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8))
        self._jsonl.write(json.dumps(
            {"tag": tag, "image": path, "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_image(tag, np.asarray(img), step,
                               dataformats="HWC")

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
