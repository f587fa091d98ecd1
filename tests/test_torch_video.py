"""The port's camera-recording reader (``torchfcn/serve/video.py``) and
``replay`` / ``launch --video`` against cv2 and tpufcn, on the CPU.

Frames: bit-equal to ``cv.VideoCapture(path)`` (OpenCV's FFmpeg backend,
which tpufcn reads through), on the committed fixture
(``tests/fixtures/video``, written by cv2's FFmpeg writer) and on a copy
whose frames carry no Huffman tables (``chip_smoke.video_without_dht``);
both digests are the ones ``chip_smoke.py`` checks on the card's host.  The
Y plane equals FFmpeg's undecorated frame (``CAP_PROP_CONVERT_RGB`` 0); the
control, each frame against FFmpeg's next frame, differs.  Frames of other
samplings (4:2:2, 4:4:4, gray) are written by ``cv.VideoWriter`` and
re-encoded by ``cv.imencode``; 4:4:0 frames and frames of odd height, which
swscale scales, are a stated deviation (ROADMAP Queue 3 item 8) bounded
here.  ``jpeg.decode`` of each frame stays ``cv.imdecode``'s (libjpeg),
which ``imread`` relies on.  Stamps and frame counts equal tpufcn's
exactly, at 15, 29.97 and 7.5 fps.  The ``replay`` / ``launch --video``
CLIs are held against tpufcn's (its
tests/test_cli_launch.py::test_cli_replay_video) on test_torch_cli.py's
constant-head weights.
"""

import json
import struct

import cv2 as cv
import numpy as np
import pytest

import chip_smoke
from test_torch_cli import MODEL, _jax_cli, _port_cli, weights  # noqa: F401
from torchfcn import cli
from torchfcn.data import jpeg
from torchfcn.serve import bus as port_bus
from torchfcn.serve.video import (
    avi_frame_chunks, iter_video_frames, read_video_frames)

FIXTURE = chip_smoke.VIDEO_FIXTURE
# frames that swscale scales (4:4:0, odd heights) against the reader's
# replicated chroma, over the frames of test_scaled_chroma_is_bounded:
# values that differ and the largest |difference| (read: 68,408 and 77)
SCALED_VALUES = 70_000
SCALED_MAX_ABS = 80


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
    ffmpeg = _capture(FIXTURE)
    assert len(ffmpeg) == len(frames)
    assert all(np.array_equal(a, b) for a, b in zip(frames, ffmpeg))
    assert chip_smoke.frames_digest(ffmpeg) == chip_smoke.frames_digest(frames) == chip_smoke.VIDEO_FRAMES_SHA256


def test_decode_keeps_libjpeg_pixels():
    """``jpeg.decode`` of each fixture frame (what imread and the record
    shards use) stays ``cv.imdecode``'s and OpenCV's own MJPEG reader's,
    which differ from FFmpeg's."""
    want, chunks = _imdecoded(FIXTURE)
    got = [jpeg.decode(c) for c in chunks]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    mjpeg = _capture(FIXTURE, cv.CAP_OPENCV_MJPEG)
    assert all(np.array_equal(a, b) for a, b in zip(got, mjpeg))
    frames, _ = read_video_frames(FIXTURE)
    assert not any(np.array_equal(a, b) for a, b in zip(got, frames))


def test_luma_equals_ffmpeg_planes():
    """The Y plane of each frame against FFmpeg's decoded frame as cv2
    hands it over unconverted (``CAP_PROP_CONVERT_RGB`` 0: the yuvj420p
    buffer's first plane, as 8UC1)."""
    _, chunks = _imdecoded(FIXTURE)
    raw = _capture(FIXTURE, cv.CAP_FFMPEG, [cv.CAP_PROP_CONVERT_RGB, 0])
    assert len(raw) == len(chunks)
    for chunk, want in zip(chunks, raw):
        planes, sub = jpeg.ffmpeg_planes(chunk)
        assert sub == (2, 2) and len(planes) == 3
        assert np.array_equal(planes[0], want.reshape(planes[0].shape))


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
    assert all(np.array_equal(jpeg.decode(c), b)
               for c, b in zip(chunks, want))
    ffmpeg = _capture(stripped)
    assert len(ffmpeg) == len(frames) == chip_smoke.VIDEO_FRAMES
    assert all(np.array_equal(a, b) for a, b in zip(frames, ffmpeg))
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
    reader's: every value equal; each frame against FFmpeg's next one (the
    control) differs."""
    frames, _ = read_video_frames(FIXTURE)
    ffmpeg = _capture(FIXTURE)
    assert len(ffmpeg) == len(frames)
    assert _ffmpeg_difference(frames, ffmpeg) == (0, 0)
    values, largest = _ffmpeg_difference(frames[:-1], ffmpeg, shift=1)
    print(f"control (the next frame): {values} values, at most {largest}")
    assert values > 0 and largest > 0


SAMPLINGS = {"420": cv.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "444": cv.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "440": cv.IMWRITE_JPEG_SAMPLING_FACTOR_440, "gray": None}


def _resampled(tmp_path, size, sampling):
    """An AVI that ``cv.VideoWriter`` writes from 3 fixture frames resized
    to ``size``, its frames re-encoded by ``cv.imencode`` at q90 with
    ``sampling`` (a gray image for "gray")."""
    src, _ = _imdecoded(FIXTURE)
    frames = [cv.resize(f, size) for f in src[:3]]
    path = str(tmp_path / f"cam_{size[0]}x{size[1]}.avi")
    w = cv.VideoWriter(path, cv.VideoWriter_fourcc(*"MJPG"), 10.0, size)
    assert w.isOpened()
    for f in frames:
        w.write(f)
    w.release()
    it = iter(frames)

    def encode(_body):
        f = next(it)
        if sampling == "gray":
            return cv.imencode(".jpg", cv.cvtColor(f, cv.COLOR_BGR2GRAY),
                               [cv.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
        return cv.imencode(".jpg", f, [
            cv.IMWRITE_JPEG_QUALITY, 90, cv.IMWRITE_JPEG_SAMPLING_FACTOR,
            SAMPLINGS[sampling]])[1].tobytes()

    with open(path, "rb") as f:
        data = chip_smoke.rewrite_avi(f.read(), encode)
    out = str(tmp_path / f"{sampling}_{size[0]}x{size[1]}.avi")
    with open(out, "wb") as f:
        f.write(data)
    return out


@pytest.mark.parametrize("sampling", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("size", [(64, 48), (63, 48)])
def test_samplings_equal_ffmpeg(sampling, size, tmp_path):
    """4:2:0 and 4:2:2 (swscale's unscaled converter), 4:4:4 (its full-
    chroma output stage) and gray frames, of even and odd widths."""
    path = _resampled(tmp_path, size, sampling)
    frames, _ = read_video_frames(path)
    ffmpeg = _capture(path)
    assert len(frames) == len(ffmpeg) == 3
    assert _ffmpeg_difference(frames, ffmpeg) == (0, 0)


def test_scaled_chroma_is_bounded(tmp_path):
    """The stated deviation: 4:4:0 frames and 4:2:0 / 4:2:2 frames of odd
    height go through swscale's bicubic chroma scaler, which the reader
    does not copy (it replicates their chroma).  Counted over these frames
    and bounded; their Y planes and a 4:4:4 frame of odd height stay
    exact."""
    values = largest = 0
    for sampling, size in (("440", (64, 48)), ("420", (64, 47)),
                           ("422", (63, 47)), ("440", (63, 47))):
        path = _resampled(tmp_path, size, sampling)
        frames, _ = read_video_frames(path)
        v, m = _ffmpeg_difference(frames, _capture(path))
        values, largest = values + v, max(largest, m)
    print(f"scaled chroma: {values} values differ, at most {largest}")
    assert 0 < values <= SCALED_VALUES and largest <= SCALED_MAX_ABS
    path = _resampled(tmp_path, (63, 47), "444")
    assert _ffmpeg_difference(read_video_frames(path)[0],
                              _capture(path)) == (0, 0)


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
    for stride, max_frames in ((1, None), (3, None), (2, 2), (1, 0),
                               (4, 9)):
        frames, stamps = read_video_frames(path, stride, max_frames)
        jframes, jstamps = jread(path, stride, max_frames)
        assert stamps == jstamps, (stride, max_frames)
        assert len(frames) == len(jframes)
        assert all(np.array_equal(a, b) for a, b in zip(frames, jframes))
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
