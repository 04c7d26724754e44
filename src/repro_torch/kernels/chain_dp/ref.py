"""Plain PyTorch version of the chaining DP: the core pipeline's own scan."""
from repro_torch.core.chaining import chain_dp as chain_dp_ref  # noqa: F401
