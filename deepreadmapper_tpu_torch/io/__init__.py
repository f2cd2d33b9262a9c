"""Sequence and result file I/O, copied from deepreadmapper_tpu/io."""
