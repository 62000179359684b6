"""The one traffic generator. A mix is a data file,
``portbench/traffic/<mix>.json``: its ``loop`` names a closed loop,
``portbench/loops/<loop>.py``, and its other keys are that loop's
parameters. The seed changes only the generated inputs (here the camera's
eye), never the sizes or the amount of work per tick.

A loop module holds everything of one kind of traffic, so that a new kind
is a new file and nothing here changes:

* ``WAVES``: the names of the traversal waves the roofline readers time,
  the first calls of the program's ``traverse_merged`` in the first tick;
* ``Loop(ctx)``: built on the context the harness makes (``pm``, the
  program's modules; ``scene``, ``config``, ``mix``, ``seed``, ``device``
  and ``camera``, the seeded camera as a dict), with ``engine`` (the
  program's engine, built in the constructor: the constructor is timed as
  the scene build), ``warm_up()`` (every shape the window uses),
  ``tick(i)`` (one unit of the user's traffic: a dict with ``seconds``, its
  host time, ``bad``, whether the tick's own audit failed, and any other
  per-tick numbers, which the record carries as lists under their keys),
  ``record()`` (further numbers for the readers) and ``answers()`` (what
  the window produced that is compared);
* ``reference(ctx, answers, control=False)``: the plain reference's
  answers, from ``portbench/reference/`` (the control with ``control``);
* ``compare(got, want)``: the numbers, ``{name: value}``, that
  ``portbench/checks/<cell>.json`` limits.
"""
from __future__ import annotations

import importlib.util
import os
import random

LOOP_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'loops')


def load_loop(name: str):
    """The module ``portbench/loops/<name>.py``."""
    path = os.path.join(LOOP_DIR, name + '.py')
    if not os.path.exists(path):
        raise ValueError(f'no traffic loop portbench/loops/{name}.py')
    spec = importlib.util.spec_from_file_location('portbench_loop_' + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeded_camera(config: dict, mix: dict, seed: int) -> dict:
    """The configuration's camera (``eye``, ``view_dir``, ``d``,
    ``focal_length``, ``aperture``) with the eye moved by a seeded offset
    of at most ``eye_jitter`` units per axis (0: as configured)."""
    cam = dict(config['camera'])
    jitter = float(mix.get('eye_jitter', 0.0))
    rng = random.Random(f'eye/{seed}')
    cam['eye'] = [float(x) + rng.uniform(-jitter, jitter) for x in cam['eye']]
    return cam


class Reservoir:
    """A uniform sample of ``k`` items from a stream of unknown length,
    drawn from the seed (Algorithm R); the items keep their stream order."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self.rng = random.Random(f'reservoir/{seed}')

    def offer(self, item):
        self.n += 1
        if len(self.items) < self.k:
            self.items.append((self.n, item))
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.items[j] = (self.n, item)

    def sample(self):
        return [item for _, item in sorted(self.items, key=lambda p: p[0])]
