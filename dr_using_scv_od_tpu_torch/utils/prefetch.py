"""Asynchronous scan prefetching for sequence streaming.

The reference's main loop decodes each scan synchronously between
processing steps (the ifstream reads inside the per-frame loop,
src/ssc.cpp:1046-1058) - on a machine where the GPU does the compute,
that serializes file IO with device time. Here a background
reader decodes scans AHEAD of the consumer into a bounded ring, so the
engine's `feed()` loop pops fully-decoded scans with zero stall in the
steady state.

Two tiers:
  * the C++ prefetcher (native/io_native.cpp: prefetch_open/next/close)
    via ctypes - a worker THREAD with mmap-based decode, no GIL during
    reads;
  * a pure-Python fallback (daemon thread + queue) with identical
    semantics when the native library is missing or predates the
    prefetcher symbols.

Both yield scans in exact file order with `io_kitti.load_scan` semantics
(unlabeled filtering, intensity scaling) applied on the consumer side.

A copy of dr_using_scv_od_tpu/utils/prefetch.py (numpy and ctypes only),
held equal to it by tests/test_torch_io.py.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from . import io_kitti


class ScanPrefetcher:
    """Iterate (xyz [n,3] f32, intensity [n] f32, labels [n] u32) over a
    scan sequence with background decode-ahead.

    Parameters mirror io_kitti.load_scan: `max_intensity` scales the raw
    reflectance; `drop_unlabeled` removes semantic 0/1 points when labels
    are present. `max_points` bounds decode capacity per scan (points
    beyond it are dropped at decode, like the pipeline's padded batch);
    `depth` is the read-ahead ring size.
    """

    def __init__(self, bin_paths: Sequence[str | Path],
                 label_paths: Optional[Sequence[str | Path]] = None,
                 max_points: int = 1 << 18, depth: int = 4,
                 max_intensity: float = 255.0,
                 drop_unlabeled: bool = True):
        self.bins = [str(p) for p in bin_paths]
        self.labs = ([str(p) if p else "" for p in label_paths]
                     if label_paths is not None
                     else [""] * len(self.bins))
        if len(self.labs) != len(self.bins):
            raise ValueError("label_paths length mismatch")
        self.max_points = int(max_points)
        self.depth = int(depth)
        self.max_intensity = float(max_intensity)
        self.drop_unlabeled = bool(drop_unlabeled)
        self._lib = self._native_with_prefetch()

    @staticmethod
    def _native_with_prefetch() -> Optional[ctypes.CDLL]:
        lib = io_kitti._native()
        if lib is None or not hasattr(lib, "prefetch_open"):
            return None
        lib.prefetch_open.restype = ctypes.c_void_p
        lib.prefetch_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.prefetch_next.restype = ctypes.c_int64
        lib.prefetch_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int64]
        lib.prefetch_close.restype = None
        lib.prefetch_close.argtypes = [ctypes.c_void_p]
        return lib

    # -- native path -------------------------------------------------------

    def _iter_native(self) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]:
        lib = self._lib
        n = len(self.bins)
        cbins = (ctypes.c_char_p * n)(*[b.encode() for b in self.bins])
        clabs = (ctypes.c_char_p * n)(*[b.encode() for b in self.labs])
        h = lib.prefetch_open(cbins, clabs, n, self.max_points, self.depth)
        if not h:
            raise IOError("prefetch_open failed")
        try:
            pts = np.empty((self.max_points, 4), np.float32)
            labels = np.empty((self.max_points,), np.uint32)
            for i in range(n):
                total = lib.prefetch_next(h, pts.ctypes.data,
                                          labels.ctypes.data,
                                          self.max_points)
                if total < 0:
                    raise IOError(
                        f"prefetch decode failed for {self.bins[i]} "
                        f"(rc={-total})")
                k = min(int(total), self.max_points)
                yield self._postprocess(pts[:k].copy(),
                                        labels[:k].copy(),
                                        bool(self.labs[i]))
        finally:
            lib.prefetch_close(h)

    # -- python fallback ---------------------------------------------------

    def _iter_python(self) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]:
        import queue
        import threading
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        END, ERR = object(), object()
        # set once the consumer has gone: the reader puts nothing more
        stop = threading.Event()

        def work():
            try:
                for b, l in zip(self.bins, self.labs):
                    full = io_kitti.read_bin(b)
                    if l:
                        labels_full = io_kitti.read_label(l)
                        if len(labels_full) != len(full):
                            raise IOError(f"scan/label mismatch: {b} {l}")
                        labels = labels_full[:self.max_points]
                    else:
                        labels = np.zeros(
                            min(len(full), self.max_points), np.uint32)
                    q.put((full[:self.max_points], labels, bool(l)))
                    if stop.is_set():
                        return
                q.put(END)
            except Exception as e:  # surfaced on the consumer side
                q.put((ERR, e))

        t = threading.Thread(target=work, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is END:
                    break
                if isinstance(item, tuple) and item[0] is ERR:
                    raise item[1]
                pts, labels, has_lab = item
                yield self._postprocess(pts, labels, has_lab)
        finally:
            # a consumer that stops early (closes the generator) frees the
            # reader: emptying the queue after `stop` is set unblocks its
            # put, after which it returns; a put it makes later finds room
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()

    # -- shared ------------------------------------------------------------

    def _postprocess(self, pts: np.ndarray, labels: np.ndarray,
                     has_labels: bool):
        if has_labels and self.drop_unlabeled:
            sem = labels & 0xFFFF
            keep = (sem != 0) & (sem != 1)
            pts, labels = pts[keep], labels[keep]
        return (pts[:, :3], pts[:, 3] * self.max_intensity, labels)

    def __iter__(self):
        if self._lib is not None:
            return self._iter_native()
        return self._iter_python()

    @property
    def native(self) -> bool:
        return self._lib is not None
