"""kernels_per_frame (kernels): device kernels (not copies or fills) in the
traced window per viewer tick."""
from portbench.lib.trace import is_copy


def read(rec):
    if rec.get('kind') != 'frames' or rec['events'] is None or not rec['ticks']:
        return None
    n = sum(1 for name, _, _ in rec['events'] if not is_copy(name))
    return n / rec['ticks']
