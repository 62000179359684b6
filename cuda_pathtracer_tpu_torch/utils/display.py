"""Display backends (counterpart of ``cuda_pathtracer_tpu/utils/display.py``).

The reference presents through a GLFW window + GL quad (src/main.cpp:188-260,
368-379). This environment is headless, so the window maps to pluggable
backends with the same contract — present(frame) + polled input:

  * HeadlessDisplay — writes PNG frames to a directory (converge runs, CI)
  * HttpDisplay    — a live in-browser viewer: serves the latest frame over
    HTTP with auto-refresh and accepts the reference key bindings via
    /key?k=w etc., feeding the same edge-triggered Keyboard abstraction the
    GLFW loop would. `python -m cuda_pathtracer_tpu_torch --serve 8000`

Frames are uint8 [H, W, 3] (or f32 display values in [0, 1]),
bottom-row-first (flipped at encode time). PNGs are encoded with the
standard library (``utils/image.py``): the machine with the card has no
imaging package.
"""
from __future__ import annotations

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .image import encode_png, save_png


class HeadlessDisplay:
    def __init__(self, out_dir: str = 'out'):
        self.out_dir = out_dir
        self.frame_idx = 0
        os.makedirs(out_dir, exist_ok=True)

    def present(self, frame: np.ndarray) -> None:
        save_png(frame, os.path.join(self.out_dir,
                                     f'frame_{self.frame_idx:05d}.png'))
        self.frame_idx += 1

    def poll_keys(self) -> set:
        return set()

    def close(self):
        pass


_PAGE = b"""<!doctype html><html><head><title>cuda_pathtracer_tpu_torch</title>
<style>body{background:#111;color:#ccc;font-family:monospace;text-align:center}
img{image-rendering:pixelated;width:85vw}</style></head><body>
<h3>cuda_pathtracer_tpu_torch &mdash; live</h3>
<img id=v src="/frame.png">
<p id=s>keys: wasd move &middot; qe up/down &middot; arrows look &middot;
n NEE &middot; c cache &middot; b blur &middot; j/k light &middot; 0-9 attach</p>
<script>
setInterval(()=>{document.getElementById('v').src='/frame.png?'+Date.now()},500);
document.addEventListener('keydown',e=>{
  fetch('/key?k='+encodeURIComponent(e.key));});
document.getElementById('v').addEventListener('click',e=>{
  const r=e.target.getBoundingClientRect();
  fetch('/click?u='+((e.clientX-r.left)/r.width)+
        '&v='+((e.clientY-r.top)/r.height));});
</script></body></html>"""


class HttpDisplay:
    """Threaded HTTP viewer; key presses queue until the render loop polls.
    ``port=0`` binds an ephemeral port; ``self.port`` is the one bound."""

    KEYMAP = {'ArrowUp': 'up', 'ArrowDown': 'down', 'ArrowLeft': 'left',
              'ArrowRight': 'right', ' ': 'space', 'CapsLock': 'caps_lock',
              'PageUp': 'page_up', 'PageDown': 'page_down'}

    def __init__(self, port: int = 8000):
        self._png = b''
        self._keys: set = set()
        self._clicks: list = []
        self._lock = threading.Lock()
        display = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.startswith('/frame.png'):
                    with display._lock:
                        data = display._png
                    self.send_response(200)
                    self.send_header('Content-Type', 'image/png')
                    self.send_header('Cache-Control', 'no-store')
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith('/click'):
                    from urllib.parse import urlparse, parse_qs
                    q = parse_qs(urlparse(self.path).query)
                    try:
                        u = float(q.get('u', ['0'])[0])
                        v = float(q.get('v', ['0'])[0])
                        with display._lock:
                            display._clicks.append((u, v))
                    except ValueError:
                        pass
                    self.send_response(204)
                    self.end_headers()
                elif self.path.startswith('/key'):
                    from urllib.parse import urlparse, parse_qs
                    q = parse_qs(urlparse(self.path).query)
                    key = q.get('k', [''])[0]
                    key = display.KEYMAP.get(key, key.lower())
                    with display._lock:
                        display._keys.add(key)
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_response(200)
                    self.send_header('Content-Type', 'text/html')
                    self.end_headers()
                    self.wfile.write(_PAGE)

        self.server = ThreadingHTTPServer(('0.0.0.0', port), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.port = self.server.server_address[1]

    def present(self, frame: np.ndarray) -> None:
        png = encode_png(frame)
        with self._lock:
            self._png = png

    def poll_keys(self) -> set:
        with self._lock:
            keys, self._keys = self._keys, set()
        return keys

    def poll_clicks(self) -> list:
        """Fractional (u, v) image clicks since the last poll; v measured
        from the top of the browser image (the render is bottom-first)."""
        with self._lock:
            clicks, self._clicks = self._clicks, []
        return clicks

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()
