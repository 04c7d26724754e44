"""``cheap_fused``'s share of its roofline over the traced window, in %: the
least time the card could take for the work the window's reads need
(``roofline/cheap_fused.py``) over the kernel's device time by name
(``run.trace_share``)."""


def read(ctx):
    return ctx["roofline"]("cheap_fused")
