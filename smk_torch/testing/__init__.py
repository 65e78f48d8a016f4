"""testing of the PyTorch port (see the twin package smk_tpu/testing)."""
