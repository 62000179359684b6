"""levels_host_ms (ms): host ms per Whitted frame inside the program's
``whitted.level`` spans, less the ``sync.*`` spans within them: the host's time
launching the levels' work (traces, shading, compaction). Read from the
program's span recorder (``cuda_pathtracer_tpu_torch/utils/profiling.py``)
per ``whitted.frame`` span of the traced window; nothing when the program
recorded no frame."""


def read(rec):
    try:
        from cuda_pathtracer_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    got = [s for s in spans() if s.end_ns is not None]
    frames = {s.frame for s in got if s.name == 'whitted.frame'}
    if not frames:
        return None
    by_id = {s.id: s for s in got}

    def in_level(s):
        p = by_id.get(s.parent)
        while p is not None:
            if p.name == 'whitted.level':
                return True
            p = by_id.get(p.parent)
        return False
    ns = sum(s.end_ns - s.start_ns for s in got
             if s.frame in frames and s.name == 'whitted.level')
    ns -= sum(s.end_ns - s.start_ns for s in got
              if s.frame in frames and s.name.startswith('sync.')
              and in_level(s))
    return ns / 1e6 / len(frames)
