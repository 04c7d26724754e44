from repro_torch.kernels.pluto_lookup.ops import lookup  # noqa: F401
