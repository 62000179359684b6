"""frame_ms_p90 (ms): the 90th percentile over all of the window's viewer
ticks of the host time from a tick's start to its frame in host memory."""
from portbench.lib.stats import percentile


def read(rec):
    if rec.get('kind') != 'frames' or not rec['tick_s']:
        return None
    return percentile(rec['tick_s'], 90) * 1e3
