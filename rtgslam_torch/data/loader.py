"""Prefetching frame loader: overlap disk I/O + decode with device compute.

Port of ``rtgslam_tpu/data/loader.py``.  A pool of worker threads decodes
frames ahead of the SLAM loop into numpy ``Camera``s (``zlib`` and the
JPEG codecs release the interpreter lock while they inflate); the copies to
the device stay on the thread that uses the frame.  ``decode_ms`` holds
each frame's decode time, by frame index.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

from .camera import Camera, CameraInfo, load_camera


class FrameLoader:
    """Iterate decoded Camera frames with ``prefetch`` frames in flight."""

    def __init__(self, args, infos: List[CameraInfo], prefetch: int = 4,
                 workers: int = 2):
        self.args = args
        self.infos = infos
        self.prefetch = max(prefetch, 1)
        self.decode_ms: Dict[int, float] = {}
        self._results: "queue.Queue[tuple[int, Camera | Exception]]" = queue.Queue()
        self._tasks: "queue.Queue[Optional[int]]" = queue.Queue()
        self._buffer = {}
        self._workers = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(max(workers, 1))
        ]
        for w in self._workers:
            w.start()

    def _worker(self):
        while True:
            idx = self._tasks.get()
            if idx is None:
                return
            try:
                t0 = time.perf_counter()
                cam = load_camera(self.args, idx, self.infos[idx])
                self.decode_ms[idx] = (time.perf_counter() - t0) * 1e3
                self._results.put((idx, cam))
            except Exception as e:  # surfaced at __next__
                self._results.put((idx, e))

    def __len__(self):
        return len(self.infos)

    def __iter__(self) -> Iterator[Camera]:
        n = len(self.infos)
        for submitted in range(min(self.prefetch, n)):
            self._tasks.put(submitted)
        submitted = min(self.prefetch, n)

        for want in range(n):
            while want not in self._buffer:
                idx, item = self._results.get()
                self._buffer[idx] = item
            item = self._buffer.pop(want)
            if isinstance(item, Exception):
                raise item
            if submitted < n:
                self._tasks.put(submitted)
                submitted += 1
            yield item

    def close(self):
        """Stop the workers and wait for them (a worker finishes the frame
        it is decoding first)."""
        for _ in self._workers:
            self._tasks.put(None)
        for w in self._workers:
            w.join(30.0)
