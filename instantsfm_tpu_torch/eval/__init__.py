"""Evaluation against ground truth (counterpart of ``instantsfm_tpu/eval/``)."""
