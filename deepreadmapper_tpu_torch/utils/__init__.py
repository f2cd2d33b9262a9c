"""Host utilities, copied from deepreadmapper_tpu/utils."""
