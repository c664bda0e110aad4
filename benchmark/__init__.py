"""The benchmark of the PyTorch and CUDA port (``m3l_tpu_torch``); see ``README.md``."""
