"""display_ms (ms): host ms per viewer tick from the rendered frame to
the uint8 image in host memory (``image()``, the display transform and
``to_uint8``), after the tick's ``finish()`` has waited for the render."""


def read(rec):
    if not rec.get('display_s'):
        return None
    return sum(rec['display_s']) / len(rec['display_s']) * 1e3
