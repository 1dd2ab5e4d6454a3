"""The port's zstd decoder (``csrc/host/zstd_decode.c`` through
``compat/zstd.py``) against the ``zstandard`` package, which serves here as
the oracle only; malformed frames; and the host build
(``compat/host_build.py``)."""

import os
import struct

import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu_torch.compat import host_build, zstd

zstandard = pytest.importorskip("zstandard")

LEVELS = (-5, 1, 3, 19)


def _inputs():
    """Random bytes; runs; float32 weights and text over 128 KiB, so that
    their frames hold several blocks (and treeless literals reuse a table
    across them)."""
    rng = np.random.RandomState(0)
    words = ["conv", "kernel", "bias", "scale", "params", "batch_stats",
             "mean", "var", "Up_0", "DoubleConv", "the", "a", "of", "0.5"]
    return {
        "random": rng.bytes(20_000),
        "runs": np.repeat(rng.randint(0, 4, 8_000),
                          rng.randint(1, 40, 8_000)).astype(np.uint8)
        .tobytes(),
        "float32_weights": (0.05 * rng.randn(40_000)).astype(np.float32)
        .tobytes(),
        "text": " ".join(rng.choice(words, 30_000)).encode(),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_matches_zstandard(kind, level, checksum, content_size):
    data = INPUTS[kind]
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=content_size).compress(data)
    assert zstd.decompress(frame) == data
    bound, exact = zstd.decoded_bound(frame)
    assert exact == content_size and bound >= len(data)
    out = torch.empty(len(data), dtype=torch.uint8)
    assert zstd.decompress_into(frame, out) == len(data)
    assert out.numpy().tobytes() == data


def test_concatenated_frames_and_a_skippable_frame():
    a, b = INPUTS["text"][:5000], INPUTS["float32_weights"]
    skippable = struct.pack("<II", 0x184D2A57, 5) + b"12345"
    stream = (zstandard.ZstdCompressor(level=3).compress(a) + skippable
              + zstandard.ZstdCompressor(level=1, write_content_size=False)
              .compress(b) + zstandard.ZstdCompressor().compress(b""))
    assert zstd.decompress(stream) == a + b
    assert zstd.decompress(skippable) == b""


def test_decompress_into_refuses_a_short_buffer():
    data = INPUTS["runs"]
    frame = zstandard.ZstdCompressor(level=3).compress(data)
    with pytest.raises(ValueError, match="too small|content size"):
        zstd.decompress_into(frame, torch.empty(len(data) - 1,
                                                dtype=torch.uint8))
    buf = torch.empty(len(data) + 7, dtype=torch.uint8)  # a larger one fits
    assert zstd.decompress_into(frame, buf) == len(data)
    assert buf[:len(data)].numpy().tobytes() == data
    with pytest.raises(ValueError, match="contiguous CPU tensor"):
        zstd.decompress_into(frame, buf[::2])


# ---------------------------------------------------------------------------
# Malformed frames raise, never read or write out of bounds
# ---------------------------------------------------------------------------

def _frame(data=None, **kwargs):
    data = INPUTS["text"][:3000] if data is None else data
    return bytearray(zstandard.ZstdCompressor(level=3, **kwargs)
                     .compress(data))


def _header_size(frame):
    fhd = frame[4]
    single, fcs_flag, did = (fhd >> 5) & 1, fhd >> 6, fhd & 3
    fcs = (1 if single else 0) if fcs_flag == 0 else 1 << fcs_flag
    return 5 + (0 if single else 1) + (0, 1, 2, 4)[did] + fcs


@pytest.mark.parametrize("cut", [1, 3, 4, 5, 8, 100, -4, -1])
def test_a_truncated_frame_raises(cut):
    frame = _frame(write_checksum=True)
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(bytes(frame[:cut]))


def test_a_reserved_block_type_raises():
    frame = _frame()
    frame[_header_size(frame)] |= 0b110  # block type 3
    with pytest.raises(ValueError, match="reserved block type"):
        zstd.decompress(bytes(frame))


def test_a_dictionary_id_raises():
    frame = _frame(write_content_size=False)
    assert not frame[4] & 0x20  # a window descriptor follows the FHD
    frame[4] |= 1  # a one-byte dictionary ID
    frame[6:6] = b"\x05"
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(bytes(frame))


def test_a_bad_magic_a_reserved_bit_a_checksum_and_a_size_raise():
    frame = _frame(write_checksum=True)
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00" + bytes(frame[1:]))
    bad = bytearray(frame)
    bad[4] |= 0x08
    with pytest.raises(ValueError, match="reserved bit"):
        zstd.decompress(bytes(bad))
    bad = bytearray(frame)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad))
    small = _frame(b"x" * 100)  # a one-byte content size of 100
    assert small[4] >> 5 & 1 and small[5] == 100
    small[5] = 99
    with pytest.raises(ValueError, match="content size|too small"):
        zstd.decompress(bytes(small))


def test_mutated_frames_decode_or_raise():
    """Random byte changes and cuts: every outcome is bytes or a
    ValueError (a fault in the decoder would take the process down)."""
    rng = np.random.RandomState(1)
    sources = [INPUTS["text"][:20_000], INPUTS["float32_weights"][:60_000],
               INPUTS["runs"][:30_000]]
    for i in range(240):
        frame = _frame(sources[i % 3], write_checksum=bool(i % 2))
        for _ in range(rng.randint(1, 5)):
            frame[rng.randint(len(frame))] = rng.randint(256)
        if i % 5 == 0:
            frame = frame[:rng.randint(len(frame))]
        try:
            zstd.decompress(bytes(frame))
        except ValueError:
            pass


# ---------------------------------------------------------------------------
# The host build
# ---------------------------------------------------------------------------

def test_the_library_builds_into_build_host_by_hash():
    lib = host_build.load_host_library()
    sources = sorted(host_build.HOST_CSRC.glob("*.c"))
    key = host_build._key(host_build._compiler(), sources)
    so = host_build.BUILD_ROOT / key / host_build.LIB_NAME
    assert so.exists() and lib._name == str(so)


def test_a_missing_compiler_raises(monkeypatch):
    monkeypatch.setenv("CC", "no-such-c-compiler")
    with pytest.raises(RuntimeError, match="no-such-c-compiler"):
        host_build._compiler()


def test_a_failing_compile_raises_with_the_compilers_output(tmp_path):
    bad = tmp_path / "bad.c"
    bad.write_text("int f(void) { return undeclared_name; }\n")
    out = tmp_path / "lib"
    with pytest.raises(RuntimeError, match="undeclared_name"):
        host_build._build(host_build._compiler(), [bad], out)
    assert not out.exists() and os.listdir(tmp_path) == ["bad.c"]
