"""The benchmark of the PyTorch and CUDA port (xlxmert_tpu_torch)."""
