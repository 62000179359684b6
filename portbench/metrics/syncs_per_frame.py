"""syncs_per_frame (syncs): the program's ``sync.*`` spans, the host's
waits for the card, per Whitted frame: those of each ``whitted.frame``'s
frame id in the traced window (the frame, its ``finish``, display and copy
to the host). Read from the program's span recorder
(``cuda_pathtracer_tpu_torch/utils/profiling.py``); nothing when the
program recorded no frame."""


def read(rec):
    try:
        from cuda_pathtracer_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    got = [s for s in spans() if s.end_ns is not None]
    frames = {s.frame for s in got if s.name == 'whitted.frame'}
    if not frames:
        return None
    n = sum(1 for s in got if s.frame in frames and s.name.startswith('sync.'))
    return n / len(frames)
