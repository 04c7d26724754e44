from repro_torch.kernels.chain_dp.ops import chain_dp, dp_read  # noqa: F401
