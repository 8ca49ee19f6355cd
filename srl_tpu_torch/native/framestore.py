"""The frame store's names (counterpart of srl_tpu/native/framestore.py)
over the port's ``.srlf`` reader and writer (``srl/episode_saver.py``),
with no native library: the reference's ``framestore.cpp`` is host code,
and numpy with one writer thread does the same work.

``FrameStoreWriter.push`` copies a batch of frames into a bounded queue and
returns; a background thread appends the batches to the file, and ``close``
drains the queue and writes the frame count into the header, as the
reference's writer does (so the two write the same bytes).
``FrameStoreReader.frames`` is a read-only memory map of a store.
"""
from __future__ import annotations

import queue
import threading
from typing import Tuple

import numpy as np

from srl_tpu_torch.srl.episode_saver import open_srlf, srlf_header

# Batches a writer holds before ``push`` waits for the disk (the
# reference's ring queue).
MAX_QUEUE = 64


def available() -> bool:
    """Always: the store needs nothing beyond numpy."""
    return True


class FrameStoreWriter:
    """Frames of ``frame_shape`` and ``dtype`` (uint8, float32 or int32),
    appended to ``path`` by a background thread."""

    def __init__(self, path: str, frame_shape: Tuple[int, ...], dtype=np.uint8):
        self.frame_shape = tuple(int(d) for d in frame_shape)
        self.dtype = np.dtype(dtype)
        self._file = open(path, "wb")
        self._file.write(srlf_header(self.dtype, self.frame_shape, 0))
        self._file.flush()
        self._queue: queue.Queue = queue.Queue(MAX_QUEUE)
        self._frames = 0
        self._error = None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            batch = self._queue.get()
            if batch is None:
                return
            try:
                batch.tofile(self._file)
                self._frames += len(batch)
            except OSError as e:
                self._error = e

    def push(self, frames: np.ndarray):
        """Queue a copy of ``frames`` [n, *frame_shape]; returns before they
        are on disk."""
        if self._thread is None:
            raise ValueError("push to a closed frame store")
        if self._error is not None:
            raise self._error
        frames = np.array(frames, self.dtype, copy=True, order="C")
        if frames.shape[1:] != self.frame_shape:
            raise ValueError(f"frames {frames.shape[1:]} != the store's {self.frame_shape}")
        self._queue.put(frames)

    def close(self) -> int:
        """Write every queued frame and the header's count; returns the
        frames written."""
        self._queue.put(None)
        self._thread.join()
        self._thread = None
        self._file.seek(0)
        self._file.write(srlf_header(self.dtype, self.frame_shape, self._frames))
        self._file.close()
        if self._error is not None:
            raise self._error
        return self._frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._thread is not None:
            self.close()


class FrameStoreReader:
    """``frames``: a read-only memory map of the store at ``path``."""

    def __init__(self, path: str):
        self.frames = open_srlf(path)

    def close(self):
        self.frames = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
