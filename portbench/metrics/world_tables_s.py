"""world_tables_s (s): host seconds in the program's ``scene.world`` spans,
the full build of ``Scene.dynamic_arrays`` (the world BVH, the wide and
packet tables, the merged table, the refit maps and templates, their copy
to the card). Read from the program's span recorder
(``cuda_pathtracer_tpu_torch/utils/profiling.py``); nothing when the
program recorded none."""


def read(rec):
    try:
        from cuda_pathtracer_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    got = [s for s in spans()
           if s.end_ns is not None and s.name == 'scene.world']
    if not got:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / 1e9
