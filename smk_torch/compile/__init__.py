"""Shape-bucket ladder math (twin of smk_tpu/compile/)."""
