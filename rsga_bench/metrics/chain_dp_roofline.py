"""``chain_dp``'s share of its roofline over the traced window, in %: the
least time the card could take for the work the window's reads need
(``roofline/chain_dp.py``) over the kernel's device time by name
(``run.trace_share``)."""


def read(ctx):
    return ctx["roofline"]("chain_dp")
