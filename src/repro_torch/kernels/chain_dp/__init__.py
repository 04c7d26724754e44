from repro_torch.kernels.chain_dp.ops import chain_dp  # noqa: F401
