"""The 95th percentile of every due read's decision time in an open loop
(``traffic.latencies_s``: from its burst's due time to its outputs on the
host; a read undecided at the close enters with its wait so far), in ms."""
import numpy as np

from rsga_bench import traffic


def read(ctx):
    r = ctx["record"]
    if r["loop"] != "bursts":
        return None
    return 1e3 * float(np.percentile(traffic.latencies_s(r), 95))
