"""scene_build_s (s): host seconds of the scene build and the engine's
constructor (``get_scene``, the BVH and tables, ``Scene.to_device``, the
dynamic arrays), the benchmark's own span around them."""


def read(rec):
    return rec['scene_build_s']
