"""Step factories of the LM substrate (the serving half: prefill and decode
steps)."""
