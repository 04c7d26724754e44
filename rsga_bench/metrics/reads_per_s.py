"""Reads mapped per second over the whole window: every read of every
chunk answered, over the seconds from the window's start to the last
answer (the chunks in flight at the close included)."""


def read(ctx):
    r = ctx["record"]
    if r["loop"] != "closed" or not r["chunks"]:
        return None
    return sum(c["n"] for c in r["chunks"]) / (r["t1"] - r["t0"])
