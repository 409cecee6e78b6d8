"""The port's ``io/images_bin.py`` against the JAX package's, on the CPU.

Mirrors ``tests/test_images_bin.py`` (the C++ reader against the numpy one,
batches, corrupt and truncated streams), and holds the port's scans and
decodes equal to the JAX module's on the same seeded streams (exact). The
port builds ``native/images_bin.cc`` into ``build/images_bin/<hash>/`` and
raises where the build fails; nothing is written under ``native/``.
"""

import numpy as np
import pytest

from yolo_sam_inference_tpu.io import images_bin as jib
from yolo_sam_inference_tpu_torch.io import images_bin as ib
from yolo_sam_inference_tpu_torch.io.png_native import NativeBuildError


@pytest.fixture
def stream(tmp_path):
    rng = np.random.default_rng(40)
    imgs = [
        rng.integers(0, 255, size=(32, 48)).astype(np.uint8),
        rng.integers(0, 255, size=(32, 48)).astype(np.uint8),
        rng.integers(0, 65535, size=(32, 48)).astype(np.uint16),
        rng.integers(0, 255, size=(32, 48, 3)).astype(np.uint8),
    ]
    p = tmp_path / "images.bin"
    ib.write_images_bin(p, imgs)
    return p, imgs


def test_scan_frames(stream):
    p, _ = stream
    frames = ib.scan_frames(p)
    assert len(frames) == 4
    assert [f[1:3] for f in frames] == [(32, 48)] * 4
    assert frames[2][3] == 2
    assert frames[3][3] == 0 + (2 << 3)
    assert frames == ib.scan_frames_plain(p) == jib.scan_frames(p)


def test_native_builds_into_build_dir():
    lib = ib.library()
    assert lib is not None
    path = ib.library_path()
    assert path.is_file() and "build" in path.parts and "native" not in path.parts


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises NativeBuildError with the
    compiler's output; no numpy reader takes its place."""
    bad = tmp_path / "images_bin.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(ib, "SOURCE", bad)
    monkeypatch.setattr(ib, "BUILD_ROOT", tmp_path / "build")
    ib._load.cache_clear()
    try:
        with pytest.raises(NativeBuildError, match="images.bin reader failed"):
            ib.scan_frames(tmp_path / "none.bin")
    finally:
        ib._load.cache_clear()


def test_read_gray8_matches_fallback(stream, monkeypatch):
    p, imgs = stream
    native = ib.read_frames_gray8(p)
    fallback = ib.read_frames_gray8_plain(p)
    monkeypatch.setattr(jib, "_lib", None)
    monkeypatch.setattr(jib, "_lib_failed", True)
    np.testing.assert_array_equal(fallback, jib.read_frames_gray8(p))
    monkeypatch.undo()
    assert native.shape == fallback.shape == (4, 32, 48)
    np.testing.assert_array_equal(native, fallback)
    np.testing.assert_array_equal(native[0], imgs[0])
    np.testing.assert_array_equal(native[1], imgs[1])
    np.testing.assert_array_equal(native, jib.read_frames_gray8(p))


def test_mixed_shapes_take_the_numpy_reader(tmp_path):
    rng = np.random.default_rng(41)
    imgs = [rng.integers(0, 255, size=s).astype(np.uint8) for s in ((16, 16), (16, 16))]
    imgs.append(rng.integers(-300, 30000, size=(16, 16)).astype(np.int16))
    p = tmp_path / "images.bin"
    ib.write_images_bin(p, imgs)
    np.testing.assert_array_equal(ib.read_frames_gray8(p), jib.read_frames_gray8(p))
    imgs.append(rng.integers(0, 255, size=(8, 12)).astype(np.uint8))
    ib.write_images_bin(p, imgs)
    frames = ib.scan_frames(p)
    with pytest.raises(ValueError):  # frames of two shapes do not stack
        ib.read_frames_gray8(p, frames)
    np.testing.assert_array_equal(ib.read_frames_gray8(p, frames[:3]),
                                  jib.read_frames_gray8(p, frames[:3]))


def test_iter_frame_batches(stream):
    p, _ = stream
    batches = list(ib.iter_frame_batches(p, batch_size=3))
    assert [b.shape[0] for b in batches] == [3, 1]
    for got, want in zip(batches, jib.iter_frame_batches(p, batch_size=3)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.uint16, np.int16, np.int32,
                                   np.float32, np.float64])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_every_depth_matches_jax(tmp_path, monkeypatch, dtype, channels):
    """Each cv depth and channel count: the C++ decode equals the port's
    numpy one and the JAX module's, and the stream bytes equal the JAX
    writer's. The JAX module's numpy fallback clamps a 16-bit signed frame
    after the mean over its channels, where its C++ reader (which both
    packages run) clamps each channel: the port's numpy reader follows the
    C++ one, so there the two numpy readers differ."""
    rng = np.random.default_rng(42)
    shape = (9, 11) if channels == 1 else (9, 11, channels)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        imgs = [rng.integers(info.min, info.max, size=shape, endpoint=True, dtype=dtype)
                for _ in range(3)]
    else:
        imgs = [rng.uniform(-20.0, 300.0, size=shape).astype(dtype) for _ in range(3)]
    ib.write_images_bin(tmp_path / "t.bin", imgs)
    jib.write_images_bin(tmp_path / "j.bin", imgs)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    got = ib.read_frames_gray8(tmp_path / "t.bin")
    np.testing.assert_array_equal(got, ib.read_frames_gray8_plain(tmp_path / "t.bin"))
    np.testing.assert_array_equal(got, jib.read_frames_gray8(tmp_path / "t.bin"))
    monkeypatch.setattr(jib, "_lib", None)
    monkeypatch.setattr(jib, "_lib_failed", True)
    fallback = jib.read_frames_gray8(tmp_path / "t.bin")
    if dtype == np.int16 and channels > 1:
        assert (got != fallback).any()
    else:
        np.testing.assert_array_equal(got, fallback)


def test_corrupt_stream_rejected(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"\x01\x00\x00\x00\x02\x00\x00\x00\xff\xff\xff\x7f")
    for scan in (ib.scan_frames, ib.scan_frames_plain):
        with pytest.raises(ValueError):
            scan(p)


def test_truncated_stream_rejected(tmp_path):
    img = np.random.default_rng(43).integers(0, 255, size=(16, 16)).astype(np.uint8)
    p = tmp_path / "trunc.bin"
    ib.write_images_bin(p, [img])
    p.write_bytes(p.read_bytes()[:-10])
    for scan in (ib.scan_frames, ib.scan_frames_plain):
        with pytest.raises(ValueError):
            scan(p)
