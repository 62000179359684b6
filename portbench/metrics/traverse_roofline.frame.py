"""traverse_roofline.frame (%): the v2 traversal kernel's share of its
roofline over the level-0 closest-hit and shadow waves of the window's
first Whitted frame: the bound is the larger of the wave's bytes at the
HBM peak and its FP32 operations at the FP32 peak, both counted from the
plain walk's visits and rows (``lib/work.py``), over the kernel's time by
CUDA events after a sleep pre-roll (``lib/timing.py``)."""


def read(rec):
    if rec.get('kind') != 'frames' or not rec['waves']:
        return None
    return 100.0 * (sum(w['bound_ms'] for w in rec['waves'])
                    / sum(w['kernel_ms'] for w in rec['waves']))
