"""Share of the traced window in which nothing ran on the card:
100 * (1 - busy / window), busy the union of the device operations'
intervals.  Serves ``device_idle_pct.<loop>`` in every cell it lists."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
