"""Video decode/encode via the native libav codec library (ctypes).

The port's copy of prisma_tpu/io/video.py: it binds the same C++ shared library
(native/codec/codec.cc, built by `make -C native` at first use) in place of the
reference's decord readers and PyAV VideoWriter.
Semantics match the reference writer: libx264, yuv420p, crf=15 default, long edge
capped at 3840, even dimensions.

The Python classes add what the batched pipeline needs and the reference lacks:
- VideoReader.batches(): a background decode thread feeding a bounded queue, so
  host decode overlaps device compute (double-buffered H2D).
- VideoWriter: an optional background encode thread draining a frame queue, so
  x264 runs concurrently with the next device step (D2H overlap).
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "lib", "libprisma_codec.so")

_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-C", os.path.join(_REPO_ROOT, "native")],
                           check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.pvc_open_reader.restype = ctypes.c_void_p
        lib.pvc_open_reader.argtypes = [ctypes.c_char_p]
        lib.pvc_reader_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_double),
                                        ctypes.POINTER(ctypes.c_int64)]
        lib.pvc_read_frame.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.pvc_close_reader.argtypes = [ctypes.c_void_p]
        lib.pvc_open_writer.restype = ctypes.c_void_p
        lib.pvc_open_writer.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_double, ctypes.c_int, ctypes.c_char_p,
                                        ctypes.c_char_p]
        lib.pvc_write_frame.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.pvc_writer_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int)]
        lib.pvc_close_writer.argtypes = [ctypes.c_void_p]
        lib.pvc_reader_skip.restype = ctypes.c_int64
        lib.pvc_reader_skip.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.pvc_concat.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
        lib.pvc_last_error.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _last_error() -> str:
    return _load_lib().pvc_last_error().decode()


_FMT_CODES = {"gray": 0, "rgb24": 1, "rgba": 2, "rgb48le": 3, "gray16le": 4}


class VideoReader:
    """Sequential RGB24 frame reader with optional background prefetch."""

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._h = self._lib.pvc_open_reader(path.encode())
        if not self._h:
            raise IOError(f"cannot open video {path}: {_last_error()}")
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        n = ctypes.c_int64()
        self._lib.pvc_reader_info(self._h, ctypes.byref(w), ctypes.byref(h),
                                  ctypes.byref(fps), ctypes.byref(n))
        self.width, self.height = w.value, h.value
        self.fps = fps.value
        self.num_frames = int(n.value)

    def skip(self, n: int) -> int:
        """Decode-and-discard n frames (no pixel conversion) — used by
        frame-index resume to seek the reader. Returns frames skipped."""
        if n <= 0:
            return 0
        skipped = self._lib.pvc_reader_skip(self._h, int(n))
        if skipped < 0:
            raise IOError(f"skip error: {_last_error()}")
        return int(skipped)

    def read(self) -> np.ndarray | None:
        """Next frame as uint8 RGB [H, W, 3], or None at EOF."""
        buf = np.empty((self.height, self.width, 3), dtype=np.uint8)
        rc = self._lib.pvc_read_frame(self._h, buf.ctypes.data_as(ctypes.c_void_p))
        if rc == 1:
            return buf
        if rc == 0:
            return None
        raise IOError(f"decode error: {_last_error()}")

    def __iter__(self):
        while (frame := self.read()) is not None:
            yield frame

    def batches(self, batch_size: int, pad_to_full: bool = False, prefetch: int = 2):
        """Yield (frames [B, H, W, 3] uint8, valid_count) with background decode.

        The final batch is short unless pad_to_full, in which case it is padded by
        repeating the last frame (so jitted shapes stay static) and valid_count
        tells the caller how many outputs to keep.
        """
        q: queue.Queue = queue.Queue(maxsize=prefetch)

        def produce():
            try:
                batch = []
                for frame in self:
                    batch.append(frame)
                    if len(batch) == batch_size:
                        q.put((np.stack(batch), batch_size))
                        batch = []
                if batch:
                    valid = len(batch)
                    if pad_to_full:
                        batch.extend([batch[-1]] * (batch_size - valid))
                    q.put((np.stack(batch), valid))
                q.put(None)
            except Exception as e:  # surface decoder errors to the consumer
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item
        t.join()

    def close(self):
        if self._h:
            self._lib.pvc_close_reader(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def concat_videos(out_path: str, segment_paths: list[str]) -> None:
    """Stream-copy concatenation of same-codec mp4 segments (native remux, no
    re-encode) — the finalize step of SegmentedVideoWriter."""
    lib = _load_lib()
    arr = (ctypes.c_char_p * len(segment_paths))(
        *[p.encode() for p in segment_paths])
    rc = lib.pvc_concat(out_path.encode(), arr, len(segment_paths))
    if rc != 0:
        raise IOError(f"concat error: {_last_error()}")


def get_video_data(path: str):
    """(width, height, fps, total_frames) — reference io.py:63-67 contract."""
    r = VideoReader(path)
    try:
        return r.width, r.height, r.fps, r.num_frames
    finally:
        r.close()


def extract_frames_from_video(video_path: str, output: str,
                              extension: str = "jpg", invert: bool = False,
                              fps: float | None = None) -> int:
    """Dump a video to numbered frames (reference io.py:214-235, an ffmpeg
    subprocess there) on the native reader: %03d.<ext> starting at 1
    (ffmpeg's numbering); invert writes 255-frame; fps resamples by
    nearest-frame skipping. Returns the frame count written."""
    import cv2

    os.makedirs(output, exist_ok=True)
    r = VideoReader(video_path)
    step = 1.0 if fps is None else max(r.fps, 1e-6) / fps
    n, acc, idx = 0, 0.0, 0
    try:
        for frame in r:
            if idx >= acc:
                n += 1
                acc += step
                if invert:
                    frame = 255 - frame
                cv2.imwrite(os.path.join(output, f"{n:03d}.{extension}"),
                            cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            idx += 1
    finally:
        r.close()
    return n


def make_video(filename: str, folder: str = ".", fps: float = 24,
               codec: str = "libx264", crf: int = 15) -> None:
    """Encode a folder of numbered images (its .png files, else its .jpg
    files, in name order) into a video (reference io.py:237-244, an ffmpeg
    subprocess there) with the native writer."""
    import glob

    import cv2

    frames = sorted(glob.glob(os.path.join(folder, "*.png"))) or \
        sorted(glob.glob(os.path.join(folder, "*.jpg")))
    if not frames:
        raise FileNotFoundError(f"no .png/.jpg frames in {folder}")
    first = cv2.imread(frames[0])
    h, w = first.shape[:2]
    writer = VideoWriter(w, h, fps, crf=crf, filename=filename, codec=codec)
    try:
        for p in frames:
            writer.write(cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB))
    finally:
        writer.close()


class VideoWriter:
    """x264 mp4 writer matching the reference VideoWriter's output settings.

    With async_encode=True, frames are queued and encoded on a background thread.
    """

    def __init__(self, width: int, height: int, frame_rate: float, crf: int = 15,
                 filename: str = "output.mp4", codec: str = "libx264",
                 async_encode: bool = True, queue_depth: int = 8,
                 preset: str | None = None):
        self._lib = _load_lib()
        if preset is None:
            # Global production knob: "" keeps x264's default ("medium", the
            # reference writer's behavior); faster presets (veryfast/ultrafast)
            # trade bitrate for encode throughput — the host-side bottleneck of
            # the 3-band pipeline (see bench_all.bench_host_io).
            preset = os.environ.get("PRISMA_X264_PRESET", "")
        self._h = self._lib.pvc_open_writer(filename.encode(), width, height,
                                            float(frame_rate), crf, codec.encode(),
                                            preset.encode())
        if not self._h:
            raise IOError(f"cannot open writer {filename}: {_last_error()}")
        w = ctypes.c_int()
        h = ctypes.c_int()
        self._lib.pvc_writer_dims(self._h, ctypes.byref(w), ctypes.byref(h))
        self.width, self.height = w.value, h.value
        self._err: Exception | None = None
        self._q: queue.Queue | None = None
        if async_encode:
            self._q = queue.Queue(maxsize=queue_depth)
            self._thread = threading.Thread(target=self._drain, daemon=True)
            self._thread.start()

    @staticmethod
    def _detect_format(frame: np.ndarray) -> str:
        if frame.ndim == 2 or frame.shape[2] == 1:
            return "gray16le" if frame.dtype == np.uint16 else "gray"
        if frame.shape[2] == 3:
            return "rgb48le" if frame.dtype == np.uint16 else "rgb24"
        if frame.shape[2] == 4:
            return "rgba"
        raise ValueError(f"unsupported frame shape {frame.shape}")

    def _encode(self, frame: np.ndarray, fmt: str | None):
        if fmt is None:
            fmt = self._detect_format(frame)
        if frame.dtype not in (np.uint8, np.uint16):
            frame = frame.astype(np.uint8)
        frame = np.ascontiguousarray(frame)
        rc = self._lib.pvc_write_frame(self._h, frame.ctypes.data_as(ctypes.c_void_p),
                                       frame.shape[1], frame.shape[0], _FMT_CODES[fmt])
        if rc != 0:
            raise IOError(f"encode error: {_last_error()}")

    def _drain(self):
        # The worker owns the native handle end-to-end: per-frame encodes AND
        # the closing flush of all lookahead-buffered frames must run on one
        # thread, or x264 emits a (slightly) different bitstream — observed as
        # nondeterministic output when close() flushed from the main thread
        # while encodes ran here.
        try:
            while True:
                item = self._q.get()
                if item is None:
                    break
                if self._err is None:  # after an error, drain without encoding
                    try:
                        self._encode(*item)
                    except Exception as e:
                        self._err = e
        finally:
            rc = self._lib.pvc_close_writer(self._h)
            self._h = None
            if rc != 0 and self._err is None:
                self._err = IOError(f"finalize error: {_last_error()}")

    def write(self, frame: np.ndarray, format: str | None = None):
        frame = np.asarray(frame)
        if self._q is not None:
            if self._err:
                raise self._err
            self._q.put((frame, format))
        else:
            self._encode(frame, format)

    def close(self):
        if self._h:
            if self._q is not None:
                self._q.put(None)
                self._thread.join()  # worker flushes + closes the native handle
                if self._err:
                    raise self._err
            else:
                rc = self._lib.pvc_close_writer(self._h)
                self._h = None
                if rc != 0:
                    raise IOError(f"finalize error: {_last_error()}")

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class SegmentedVideoWriter:
    """Resumable mp4 writer (SURVEY.md §5 failure/resume).

    Frames are encoded into fixed-size segments under <filename>.segments/;
    close() stream-copy-concatenates them into the final mp4 and removes the
    directory. A killed run leaves the completed segments behind; a re-run
    calls completed_frames() to find the resume index (only fully-written,
    readable segments count), seeks the reader, and continues at the next
    segment — producing byte-identical output to an uninterrupted run, because
    the uninterrupted run writes the very same segments.

    workers > 1 turns the segment structure into an encode POOL: a finished
    segment's x264 flush/close runs on its own thread while the producer
    streams frames into the next segment's writer, so up to `workers` x264
    instances run concurrently. Each segment is encoded by its own encoder
    instance from a fixed frame range, so the output bitstream is the same
    bytes regardless of workers. Memory: a slow encoder can buffer up to one
    whole segment of frames (segment_frames x H x W x 3 bytes, ~400 MB for 64
    frames of 1080p) per in-flight segment.
    """

    def __init__(self, width: int, height: int, frame_rate: float,
                 filename: str, segment_frames: int = 64, crf: int = 15,
                 codec: str = "libx264", start_frame: int = 0,
                 async_encode: bool = True, preset: str | None = None,
                 workers: int = 1):
        if segment_frames <= 0:
            raise ValueError("segment_frames must be positive")
        if start_frame % segment_frames:
            raise ValueError("start_frame must sit on a segment boundary")
        self.filename = filename
        self.seg_dir = filename + ".segments"
        self.segment_frames = segment_frames
        self._wh = (width, height)
        self._fps = frame_rate
        self._crf = crf
        self._codec = codec
        self._preset = preset
        self._async = async_encode
        self._workers = max(1, int(workers))
        self._seg_idx = start_frame // segment_frames
        self._in_seg = 0
        self._writer: VideoWriter | None = None
        self._closing: list[threading.Thread] = []
        self._close_err: list[Exception] = []
        os.makedirs(self.seg_dir, exist_ok=True)
        # dimensions after the writer's cap/rounding, for callers
        probe = VideoWriter(width, height, frame_rate, crf=crf,
                            filename=os.path.join(self.seg_dir, "_probe.mp4"),
                            codec=codec, async_encode=False)
        self.width, self.height = probe.width, probe.height
        probe.close()
        os.remove(os.path.join(self.seg_dir, "_probe.mp4"))

    def _seg_path(self, idx: int) -> str:
        return os.path.join(self.seg_dir, f"{idx:06d}.mp4")

    def _finish_segment(self, writer: VideoWriter):
        """Close a full segment; with a pool, on a background thread."""
        if self._workers == 1:
            writer.close()
            return
        if self._close_err:
            raise self._close_err[0]

        def closer():
            try:
                writer.close()
            except Exception as e:  # surfaced on the next write()/close()
                self._close_err.append(e)

        t = threading.Thread(target=closer, daemon=True)
        t.start()
        self._closing.append(t)
        # bound the pool: wait for the oldest flush once `workers` are in flight
        while len(self._closing) >= self._workers:
            self._closing.pop(0).join()

    def write(self, frame: np.ndarray, format: str | None = None):
        if self._writer is None:
            # pool mode buffers the whole segment so a slow encoder never
            # stalls the producer mid-segment
            depth = self.segment_frames if self._workers > 1 else 8
            self._writer = VideoWriter(
                self._wh[0], self._wh[1], self._fps, crf=self._crf,
                filename=self._seg_path(self._seg_idx), codec=self._codec,
                async_encode=self._async, preset=self._preset,
                queue_depth=depth)
        self._writer.write(frame, format)
        self._in_seg += 1
        if self._in_seg == self.segment_frames:
            w, self._writer = self._writer, None
            self._seg_idx += 1
            self._in_seg = 0
            self._finish_segment(w)

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        for t in self._closing:
            t.join()
        self._closing = []
        if self._close_err:
            raise self._close_err[0]
        segs = [self._seg_path(i)
                for i in range(self._seg_idx + (1 if self._in_seg else 0))]
        if segs:
            concat_videos(self.filename, segs)
        import shutil
        shutil.rmtree(self.seg_dir, ignore_errors=True)

    @staticmethod
    def completed_frames(filename: str, segment_frames: int) -> int:
        """Frames recoverable from a previous (interrupted) run: the length of
        the contiguous run of full, readable segments starting at 0."""
        seg_dir = filename + ".segments"
        if not os.path.isdir(seg_dir):
            return 0
        done = 0
        idx = 0
        while True:
            p = os.path.join(seg_dir, f"{idx:06d}.mp4")
            if not os.path.exists(p):
                break
            try:
                r = VideoReader(p)
                n = r.num_frames
                r.close()
            except Exception:
                break
            if n != segment_frames:
                break
            done += segment_frames
            idx += 1
        return done
