"""mzbench: the benchmark of ``multiz_tpu_torch``, the PyTorch and CUDA
port of the multiz/TBA aligner. See README.md."""
