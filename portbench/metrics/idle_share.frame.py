"""idle_share.frame (%): the share of the traced window in which no
operation ran on the card, viewer-tick cells."""
from portbench.lib.trace import busy_us


def read(rec):
    if rec.get('kind') != 'frames' or rec['events'] is None:
        return None
    busy = busy_us([(s, e) for _, s, e in rec['events']])[0] / 1e6
    return 100.0 * (1.0 - busy / rec['window_s'])
