from repro_torch.kernels.gain_reduce.ops import gain_reduce  # noqa: F401
