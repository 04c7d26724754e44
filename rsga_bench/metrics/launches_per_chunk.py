"""Device operations (kernels, copies, memsets) in the traced window per
chunk the window dispatched.  Serves ``launches_per_chunk.<loop>`` in every
cell it lists."""


def read(ctx):
    r, t = ctx["record"], ctx["trace"]
    if t is None or not r["chunks"]:
        return None
    return t["n_device_ops"] / len(r["chunks"])
