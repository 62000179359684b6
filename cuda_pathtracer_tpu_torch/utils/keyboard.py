"""Edge-triggered keyboard abstraction (counterpart of
``cuda_pathtracer_tpu/utils/keyboard.py``).

The reference double-buffers the GLFW key map so isPressed/isReleased are
edge-triggered within a tick (src/keyboard.h:40-103). This version is
backend-agnostic: any input source feeds `set_down()` with the currently-held
action names each tick, then `swap_buffers()` latches the edge state. The
action vocabulary mirrors the reference ACTION enum and its key bindings
(src/keyboard.h:7-38,106-138).
"""
from __future__ import annotations

ACTIONS = (
    'move_right', 'move_left', 'move_forward', 'move_backward',
    'move_up', 'move_down',
    'look_up', 'look_down', 'look_left', 'look_right',
    'switch_mode', 'switch_nee', 'switch_cache', 'switch_converge',
    'switch_blur',
    *(f'attach_{i}' for i in range(10)),
    'focus',
    'aperture_up', 'aperture_down',
    'light_dim', 'light_brighten',
)

# reference key bindings (src/keyboard.h:106-138 + main.cpp:396-411 direct keys)
DEFAULT_KEYMAP = {
    'a': 'move_left', 'd': 'move_right', 'w': 'move_forward',
    's': 'move_backward', 'q': 'move_up', 'e': 'move_down',
    'up': 'look_up', 'down': 'look_down', 'left': 'look_left',
    'right': 'look_right',
    'space': 'switch_mode', 'n': 'switch_nee', 'c': 'switch_cache',
    'caps_lock': 'switch_converge', 'b': 'switch_blur',
    **{str(i): f'attach_{i}' for i in range(10)},
    'x': 'focus',
    'page_up': 'aperture_up', 'page_down': 'aperture_down',
    'j': 'light_dim', 'k': 'light_brighten',
}


class Keyboard:
    def __init__(self, keymap: dict | None = None):
        self.keymap = dict(DEFAULT_KEYMAP if keymap is None else keymap)
        self._down: set[str] = set()
        self._old: set[str] = set()

    def set_down(self, actions_or_keys) -> None:
        """Feed the set of currently held action names (or raw key names,
        translated through the keymap)."""
        acts = set()
        for item in actions_or_keys:
            acts.add(self.keymap.get(item, item))
        self._down = acts

    def swap_buffers(self) -> None:
        self._old = set(self._down)

    def is_down(self, action: str) -> bool:
        return action in self._down

    def is_pressed(self, action: str) -> bool:
        return action in self._down and action not in self._old

    def is_released(self, action: str) -> bool:
        return action not in self._down and action in self._old
