"""Mean host milliseconds inside the program's chunk function (the
harness's ``map_fn`` spans) a chunk, over every chunk of the window.
Serves ``host_dispatch_ms.<loop>`` in every cell it lists."""


def read(ctx):
    d = [t1 - t0 for name, t0, t1 in ctx["spans"] if name == "map_fn"]
    return 1e3 * sum(d) / len(d) if d else None
