"""The port's camera-recording reader (``torchfcn/serve/video.py``) and
``replay`` / ``launch --video`` against cv2 and tpufcn, on the CPU.

Frames: bit-equal to ``cv.imdecode`` of each frame chunk and to
``cv.VideoCapture(path, cv.CAP_OPENCV_MJPEG)``, on the committed fixture
(``tests/fixtures/video``, written by cv2's FFmpeg writer) and on a copy
whose frames carry no Huffman tables (``chip_smoke.video_without_dht``);
both digests are the ones ``chip_smoke.py`` checks on the card's host.

tpufcn reads through ``cv.VideoCapture(path)``, whose FFmpeg backend has its
own IDCT and colour conversion, so its frames differ from libjpeg's (ROADMAP
Queue 3 item 8).  That difference is counted on the fixture and bounded at
``FFMPEG_VALUES`` values and ``FFMPEG_MAX_ABS`` (read: 1,992,957 of 2,764,800
values, by at most 26); the control, each frame against FFmpeg's next
frame, breaks the bound.  Stamps and frame counts equal tpufcn's exactly,
at 15, 29.97 and 7.5 fps.  The ``replay`` / ``launch --video`` CLIs are
held against tpufcn's (its tests/test_cli_launch.py::test_cli_replay_video)
on test_torch_cli.py's constant-head weights.
"""

import json
import struct

import cv2 as cv
import numpy as np
import pytest

import chip_smoke
from test_torch_cli import MODEL, _jax_cli, _port_cli, weights  # noqa: F401
from torchfcn import cli
from torchfcn.serve import bus as port_bus
from torchfcn.serve.video import (
    avi_frame_chunks, iter_video_frames, read_video_frames)

FIXTURE = chip_smoke.VIDEO_FIXTURE
# the FFmpeg backend's frames against the reader's over the fixture: values
# that differ and the largest |difference| (read: 1,992,957 and 26)
FFMPEG_VALUES = 2_100_000
FFMPEG_MAX_ABS = 32


def _capture(path, *backend):
    cap = cv.VideoCapture(path, *backend)
    assert cap.isOpened()
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def _imdecoded(path):
    with open(path, "rb") as f:
        data = f.read()
    _, chunks = avi_frame_chunks(data)
    return [cv.imdecode(np.frombuffer(data[s:s + n], np.uint8),
                        cv.IMREAD_COLOR) for s, n in chunks], \
        [data[s:s + n] for s, n in chunks]


@pytest.fixture(scope="module")
def stripped(tmp_path_factory):
    """The fixture with its frames carrying no Huffman tables."""
    path = str(tmp_path_factory.mktemp("video") / "no_dht.avi")
    with open(FIXTURE, "rb") as f:
        data = chip_smoke.video_without_dht(f.read())
    with open(path, "wb") as f:
        f.write(data)
    return path


def test_fixture_frames_equal_cv2():
    frames, stamps = read_video_frames(FIXTURE)
    assert len(frames) == chip_smoke.VIDEO_FRAMES
    assert stamps == [i / chip_smoke.VIDEO_FPS for i in range(len(frames))]
    assert frames[0].shape == (240, 320, 3) and frames[0].dtype == np.uint8
    want, _ = _imdecoded(FIXTURE)
    assert all(np.array_equal(a, b) for a, b in zip(frames, want))
    mjpeg = _capture(FIXTURE, cv.CAP_OPENCV_MJPEG)
    assert len(mjpeg) == len(frames)
    assert all(np.array_equal(a, b) for a, b in zip(frames, mjpeg))
    assert chip_smoke.frames_digest(mjpeg) == chip_smoke.frames_digest(frames) == chip_smoke.VIDEO_FRAMES_SHA256


def _segments(jpeg: bytes) -> list:
    out, pos = [], 2
    while jpeg[pos + 1] != 0xDA:
        out.append(jpeg[pos + 1])
        pos += 2 + struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
    return out


def test_frames_without_huffman_tables_equal_cv2(stripped):
    """Frames with no DHT segment decode with the standard tables, as
    libjpeg does; the rewritten container reads in cv2 too."""
    frames, stamps = read_video_frames(stripped)
    want, chunks = _imdecoded(stripped)
    assert all(0xC4 not in _segments(c) for c in chunks)
    assert all(0xC4 in _segments(c) for c in _imdecoded(FIXTURE)[1])
    assert all(np.array_equal(a, b) for a, b in zip(frames, want))
    mjpeg = _capture(stripped, cv.CAP_OPENCV_MJPEG)
    assert len(mjpeg) == len(frames) == chip_smoke.VIDEO_FRAMES
    assert all(np.array_equal(a, b) for a, b in zip(frames, mjpeg))
    assert stamps == read_video_frames(FIXTURE)[1]
    assert chip_smoke.frames_digest(frames) == chip_smoke.VIDEO_STRIPPED_SHA256
    # the fixture's own tables are optimised: cut out, its frames would
    # decode to other pixels (cv2 warns of corrupt data)
    cut = chip_smoke.jpeg_without_dht(_imdecoded(FIXTURE)[1][0])
    bad = cv.imdecode(np.frombuffer(cut, np.uint8), cv.IMREAD_COLOR)
    assert bad is None or not np.array_equal(bad, frames[0])


def _ffmpeg_difference(frames, ffmpeg, shift=0):
    d = [np.abs(a.astype(np.int64) - b) for a, b in
         zip(frames, ffmpeg[shift:])]
    return sum(int((x > 0).sum()) for x in d), max(int(x.max()) for x in d)


def test_ffmpeg_difference_is_bounded():
    """tpufcn's frames (cv.VideoCapture's FFmpeg backend) against the
    reader's: the same count, the values within the stated bound; each
    frame against FFmpeg's next one (the control) breaks it."""
    frames, _ = read_video_frames(FIXTURE)
    ffmpeg = _capture(FIXTURE)
    assert len(ffmpeg) == len(frames)
    values, largest = _ffmpeg_difference(frames, ffmpeg)
    print(f"FFmpeg against the reader: {values} of "
          f"{sum(f.size for f in frames)} values differ, at most {largest}")
    assert 0 < values <= FFMPEG_VALUES and largest <= FFMPEG_MAX_ABS
    values, largest = _ffmpeg_difference(frames[:-1], ffmpeg, shift=1)
    print(f"control (the next frame): {values} values, at most {largest}")
    assert largest > FFMPEG_MAX_ABS


@pytest.mark.parametrize("fps", [15.0, 29.97, 7.5])
def test_stride_max_frames_and_stamps_match_tpufcn(fps, tmp_path):
    from tpufcn.serve.video import read_video_frames as jread
    path = str(tmp_path / "cam.avi")
    w = cv.VideoWriter(path, cv.VideoWriter_fourcc(*"MJPG"), fps, (64, 48))
    assert w.isOpened()
    rng = np.random.default_rng(int(fps * 100))
    for i in range(7):
        w.write(np.full((48, 64, 3), i * 30, np.uint8)
                + rng.integers(0, 20, (48, 64, 3), dtype=np.uint8))
    w.release()
    imdecoded, _ = _imdecoded(path)
    for stride, max_frames in ((1, None), (3, None), (2, 2), (1, 0),
                               (4, 9)):
        frames, stamps = read_video_frames(path, stride, max_frames)
        jframes, jstamps = jread(path, stride, max_frames)
        assert stamps == jstamps, (stride, max_frames)
        assert len(frames) == len(jframes)
        want = imdecoded[::stride][:len(frames)]
        assert all(np.array_equal(a, b) for a, b in zip(frames, want))
    assert read_video_frames(path)[1][1] == 1 / fps
    capped = list(iter_video_frames(path, max_frames=2))
    assert len(capped) == 2


def _rewrite_codec(data: bytes, fourcc: bytes) -> bytes:
    """``data`` with its stream header's handler and its format's
    compression fourcc replaced."""
    out = bytearray(data)
    strh = out.index(b"strh") + 8
    strf = out.index(b"strf") + 8
    out[strh + 4:strh + 8] = fourcc
    out[strf + 16:strf + 20] = fourcc
    return bytes(out)


def test_refusals_name_the_file_and_the_frame(tmp_path):
    with pytest.raises(FileNotFoundError, match="cannot open video"):
        read_video_frames(str(tmp_path / "missing.avi"))
    with pytest.raises(ValueError, match="stride"):
        read_video_frames(FIXTURE, stride=0)
    png = str(tmp_path / "frame.png")
    cv.imwrite(png, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match=r"frame\.png: not an AVI"):
        read_video_frames(png)
    with open(FIXTURE, "rb") as f:
        data = f.read()
    h264 = str(tmp_path / "h264.avi")
    with open(h264, "wb") as f:
        f.write(_rewrite_codec(data, b"H264"))
    with pytest.raises(ValueError, match="h264.avi: video codec b'H264'"):
        read_video_frames(h264)
    # frame 2 without its start-of-image marker: the error names the frame
    _, chunks = avi_frame_chunks(data)
    start, _ = chunks[2]
    broken = bytearray(data)
    broken[start:start + 2] = b"\x00\x00"
    bad = str(tmp_path / "broken.avi")
    with open(bad, "wb") as f:
        f.write(bytes(broken))
    frames = list(iter_video_frames(bad, max_frames=2))
    assert len(frames) == 2
    with pytest.raises(ValueError, match="broken.avi, frame 2: not a JPEG"):
        read_video_frames(bad)


@pytest.fixture(scope="module")
def camera(tmp_path_factory):
    """tpufcn's test recording: 4 noise frames at 5 fps (224x224, the
    model's size)."""
    path = str(tmp_path_factory.mktemp("cam") / "cam.avi")
    w = cv.VideoWriter(path, cv.VideoWriter_fourcc(*"MJPG"), 5.0, (224, 224))
    rng = np.random.default_rng(0)
    for _ in range(4):
        w.write(rng.integers(0, 256, (224, 224, 3)).astype(np.uint8))
    w.release()
    return path


def test_cli_replay_video_matches_tpufcn(camera, weights, tmp_path, capsys,
                                         monkeypatch):
    argv = ["replay", "--video", camera, "--video-stride", "2", "--model",
            MODEL, "--weights", weights]
    want = _jax_cli(argv, capsys, monkeypatch)
    got = _port_cli(argv, capsys)
    assert got == want
    assert got[-1] == {"frames_processed": 2}     # 4 frames, stride 2
    assert all(r["detections"] > 0 for r in got[:-1])
    argv = ["replay", "--video", camera, "--max-frames", "3", "--model",
            MODEL, "--weights", weights]
    assert _port_cli(argv, capsys)[-1] == {"frames_processed": 3}
    with pytest.raises(SystemExit):                # images XOR --video
        cli.main(["replay", str(tmp_path / "f.png"), "--video", camera,
                  "--device", "cpu"])


def test_cli_launch_video_matches_tpufcn(camera, weights, tmp_path, capsys,
                                         monkeypatch):
    """``launch --video``: the same JSON line as tpufcn's, and the frames
    published with the same source stamps."""
    import tpufcn.serve.bus as jax_bus
    spec = {"fcn_object_detector": {
        "type": "detector",
        "params": {"model": MODEL, "pretrained_weights": weights,
                   "micro_batch": 2},
        "remap": {"image": "image"}}}
    path = str(tmp_path / "graph.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    stamps = {"port": [], "jax": []}
    for key, module in (("port", port_bus), ("jax", jax_bus)):
        real = module.TopicBus.publish

        def publish(self, topic, data, stamp=None, _real=real, _key=key):
            if topic == "image":
                stamps[_key].append(stamp)
            return _real(self, topic, data, stamp)

        monkeypatch.setattr(module.TopicBus, "publish", publish)
    argv = ["launch", path, "--video", camera, "--video-stride", "3"]
    want = _jax_cli(argv, capsys, monkeypatch)
    got = _port_cli(argv, capsys)
    assert got == want == [{"nodes": ["fcn_object_detector"],
                            "frames_published": 2,
                            "processed": {"fcn_object_detector": 2}}]
    assert stamps["port"] == stamps["jax"] == [0.0, 0.6]
    with pytest.raises(SystemExit):                # --frames XOR --video
        cli.main(["launch", path, "--frames", "f.png", "--video", camera,
                  "--device", "cpu"])
