"""parallel of the PyTorch port (see the twin package smk_tpu/parallel)."""
