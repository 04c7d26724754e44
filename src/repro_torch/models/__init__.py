"""LM substrate: one flexible stack covering all 10 assigned architectures
(the serving path: init, forward, loss value, KV/SSM cache, prefill and
decode)."""
