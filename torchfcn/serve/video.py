"""Camera recordings as a frame source for the stream surfaces
(``tpufcn/serve/video.py``), without cv2.

``cli replay --video`` and ``cli launch --video`` drive the node graphs with
the frames of a video file and their source stamps, as a ``rosbag play`` of
the camera topic would.  The JAX package decodes through
``cv2.VideoCapture``; the card's host has no cv2, so this module reads the
container itself: Motion-JPEG in an AVI (RIFF) file, the format of USB
cameras and of OpenCV's own ``MJPG`` writer.  Each frame is decoded by
``torchfcn.data.jpeg.decode_ffmpeg`` as ``cv.VideoCapture(path)`` decodes it
through FFmpeg: FFmpeg's MJPEG decoder (its integer ``simple_idct``) and
swscale's conversion to BGR, bit for bit for 4:2:0 and 4:2:2 frames of
even height, 4:4:4 and gray frames.  Frames of odd height and 4:4:0 frames
go through swscale's bicubic chroma scaler, which is not copied (ROADMAP
Queue 3 item 8).  ``cv.imdecode`` of a frame (libjpeg's arithmetic, which
``torchfcn.data.jpeg.decode`` and ``imread`` keep) differs from these
pixels by a few units.

The reader walks ``RIFF AVI `` and any ``AVIX`` extensions: the first video
stream's ``strh`` / ``strf`` in ``LIST hdrl``, then its ``##dc`` / ``##db``
chunks in ``LIST movi`` (and ``LIST rec ``) in file order, odd sizes padded;
``JUNK``, ``LIST odml``, ``idx1``, ``ix##`` and other streams' chunks are
skipped.  Its frame rate is the stream header's ``dwRate / dwScale``, 30 where
that is 0 (cv2's default).  A missing file raises ``FileNotFoundError``;
anything but an AVI, or a codec other than MJPG, raises ``ValueError``
naming it; a frame that does not decode raises ``ValueError`` naming its
index.
"""

from __future__ import annotations

import mmap
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from torchfcn.data.jpeg import decode_ffmpeg

__all__ = ["iter_video_frames", "read_video_frames", "avi_frame_chunks"]

# the frame rate of a stream header without one (cv2's default)
DEFAULT_FPS = 30.0
MJPG = b"MJPG"


def _chunks(buf, pos: int, end: int):
    """(fourcc, body start, body size, list type or None) of each chunk
    between ``pos`` and ``end``, sizes padded to even."""
    while pos + 8 <= end:
        fourcc = bytes(buf[pos:pos + 4])
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        body = pos + 8
        if body + size > len(buf):
            raise ValueError(f"chunk {fourcc!r} at byte {pos} runs past the "
                             f"end of the file")
        kind = bytes(buf[body:body + 4]) if fourcc in (b"RIFF", b"LIST") \
            else None
        yield fourcc, body, size, kind
        pos = body + size + (size & 1)


def _video_stream(buf, start: int, end: int, path: str) -> tuple:
    """(stream index, fps) of the first ``vids`` stream of ``LIST hdrl``;
    raises unless its codec is MJPG."""
    index = 0
    for fourcc, body, size, kind in _chunks(buf, start, end):
        if kind != b"strl":
            continue
        header = fmt = None
        for sub, sbody, ssize, _ in _chunks(buf, body + 4, body + size):
            if sub == b"strh" and ssize >= 36:
                header = sbody
            elif sub == b"strf":
                fmt = (sbody, ssize)
        if header is not None and bytes(buf[header:header + 4]) == b"vids":
            handler = bytes(buf[header + 4:header + 8])
            codec = bytes(buf[fmt[0] + 16:fmt[0] + 20]) \
                if fmt is not None and fmt[1] >= 20 else handler
            if codec.upper() != MJPG:
                raise ValueError(f"{path}: video codec {codec!r} (stream "
                                 f"{index}): only MJPG (Motion-JPEG) AVIs are "
                                 f"read")
            scale, rate = struct.unpack_from("<II", buf, header + 20)
            fps = rate / scale if scale and rate else DEFAULT_FPS
            return index, fps
        index += 1
    raise ValueError(f"{path}: an AVI without a video stream")


def _movi(buf, body: int, size: int, ids: tuple, out: list) -> None:
    """The video stream's frame chunks of a ``LIST movi`` (or ``rec ``) as
    (start, size), in file order."""
    for fourcc, cbody, csize, kind in _chunks(buf, body + 4, body + size):
        if kind == b"rec ":
            _movi(buf, cbody, csize, ids, out)
        elif fourcc in ids and csize:
            out.append((cbody, csize))


def avi_frame_chunks(buf, path: str = "<buffer>") -> Tuple[float, list]:
    """(fps, [(start, size) of each frame's JPEG bytes in ``buf``]) of an
    MJPG AVI held in ``buf`` (bytes or a memory map)."""
    if len(buf) < 12 or bytes(buf[:4]) != b"RIFF" \
            or bytes(buf[8:12]) != b"AVI ":
        raise ValueError(f"{path}: not an AVI file (no RIFF 'AVI ' header)")
    stream = None
    frames: List[tuple] = []
    for fourcc, body, size, kind in _chunks(buf, 0, len(buf)):
        if fourcc != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
            continue
        for sub, sbody, ssize, skind in _chunks(buf, body + 4, body + size):
            if skind == b"hdrl" and stream is None:
                stream = _video_stream(buf, sbody + 4, sbody + ssize, path)
            elif skind == b"movi":
                if stream is None:
                    raise ValueError(f"{path}: frames before the AVI's "
                                     f"stream headers")
                ids = tuple(b"%02d%s" % (stream[0], t) for t in (b"dc",
                                                                 b"db"))
                _movi(buf, sbody, ssize, ids, frames)
    if stream is None:
        raise ValueError(f"{path}: an AVI without stream headers")
    return stream[1], frames


def iter_video_frames(path: str,
                      stride: int = 1,
                      max_frames: Optional[int] = None,
                      ) -> Iterator[Tuple[float, np.ndarray]]:
    """Yield ``(stamp_seconds, bgr_frame)`` from an MJPG AVI file.

    ``stride`` keeps every Nth frame (decimation for long recordings);
    stamps are the *source* timestamps (frame_index / fps), so sync
    policies observe the capture cadence even under decimation.
    ``max_frames`` bounds the number of frames *yielded*.  Only the frames
    yielded are decoded.
    """
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    try:
        f = open(path, "rb")
    except OSError as e:
        raise FileNotFoundError(f"cannot open video: {path}") from e
    with f:
        if not f.seek(0, 2):
            raise ValueError(f"{path}: an empty file, not an AVI")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
            fps, frames = avi_frame_chunks(buf, path)
            yielded = 0
            for idx in range(0, len(frames), stride):
                if max_frames is not None and yielded >= max_frames:
                    return
                start, size = frames[idx]
                yield idx / fps, decode_ffmpeg(buf[start:start + size],
                                               f"{path}, frame {idx}")
                yielded += 1


def read_video_frames(path: str,
                      stride: int = 1,
                      max_frames: Optional[int] = None,
                      ) -> Tuple[List[np.ndarray], List[float]]:
    """Decode a video file into ``(frames, stamps)`` lists (see
    :func:`iter_video_frames`)."""
    frames: List[np.ndarray] = []
    stamps: List[float] = []
    for stamp, frame in iter_video_frames(path, stride=stride,
                                          max_frames=max_frames):
        frames.append(frame)
        stamps.append(stamp)
    return frames, stamps
