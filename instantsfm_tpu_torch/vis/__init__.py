"""Reconstruction viewers and recorder (counterpart of ``instantsfm_tpu/vis/``)."""
