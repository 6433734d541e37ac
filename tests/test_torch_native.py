"""The port's host-IO library (shardmerge_tpu_torch/io/native.py over its
own csrc/stio.cpp, built here with the system C++ compiler): bit-exact
against torch's copy and f32 -> bf16 cast (round to nearest even) on every
non-NaN value, NaNs kept with their sign, the widening, parallel preads,
and a build failure that raises with the compiler's message."""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch

from shardmerge_tpu_torch.io import native


def _special_f32() -> torch.Tensor:
    """Ties at every rounding position, both zeros, infinities, the largest
    finite value, subnormals and values that round up into the exponent."""
    words = [0x3F808000, 0x3F818000, 0x3F80C000, 0x3F807FFF, 0x00000001, 0x807FFFFF, 0x7F7FFFFF, 0xFF7FFFFF,
             0x7F800000, 0xFF800000, 0x00000000, 0x80000000, 0x3FFFFFFF, 0x477FFFFF, 0x33800000, 0x007F8000]
    return torch.from_numpy(np.array(words, dtype=np.uint32).view(np.float32))


@pytest.mark.parametrize("n", [0, 1, 4097, (1 << 20) + 3, 3 << 20])
def test_copy_and_casts_are_bit_exact_with_torch(n):
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=gen) * torch.exp(torch.randn(n, generator=gen) * 20)
    if n >= 16:
        x[:16] = _special_f32()
    got = native.f32_to_bf16(x)
    assert torch.equal(got.view(torch.int16), x.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(native.parallel_copy(x).view(torch.int32), x.view(torch.int32))
    wide = native.bf16_to_f32(got)
    assert torch.equal(wide.view(torch.int32), got.float().view(torch.int32))
    out = torch.empty(x.shape, dtype=torch.bfloat16)
    assert native.f32_to_bf16(x, out=out) is out


def test_nans_stay_nans_with_their_sign_and_payload_top_bits():
    """A NaN keeps its sign and the top of its payload, quieted (the JAX
    package's stio rule); torch's own cast and ml_dtypes canonicalize, so
    NaNs are the one place the bits may differ from theirs."""
    words = np.array([0x7FC00000, 0xFFC00001, 0x7F800001, 0x7FA12345, 0xFFFFFFFF], dtype=np.uint32)
    got = native.f32_to_bf16(torch.from_numpy(words.view(np.float32))).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, (words >> 16).astype(np.uint16) | 0x0040)
    with np.errstate(invalid="ignore"):
        want = words.view(np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(got & 0x8000, want & 0x8000)
    assert np.isnan(got.view(ml_dtypes.bfloat16).astype(np.float32)).all()


def test_read_blocks_and_prefault(tmp_path):
    data = np.random.default_rng(0).integers(0, 256, 1 << 16, dtype=np.uint8)
    path = tmp_path / "blob.bin"
    path.write_bytes(data.tobytes())
    offsets, sizes = [0, 100, 40000], [10, 5000, 25536]
    bufs = [torch.empty(s, dtype=torch.uint8) for s in sizes]
    assert native.read_blocks(path, offsets, sizes, bufs)
    for off, size, buf in zip(offsets, sizes, bufs):
        np.testing.assert_array_equal(buf.numpy(), data[off:off + size])
    short = [torch.empty(100, dtype=torch.uint8)]
    assert not native.read_blocks(path, [len(data) - 10], [100], short)
    native.prefault_file(path)
    native.prefault_file(path, offset=100, length=10**9)
    with pytest.raises(ValueError, match="contiguous"):
        native.read_blocks(path, [0], [10], [torch.empty(4, dtype=torch.uint8)])


def test_wrong_inputs_are_refused():
    with pytest.raises(ValueError, match="float32"):
        native.f32_to_bf16(torch.zeros(3, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        native.bf16_to_f32(torch.zeros(3))
    with pytest.raises(ValueError, match="out must be"):
        native.parallel_copy(torch.zeros(3), out=torch.zeros(4))


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    bad = tmp_path / "stio.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed .* building .*stio.cpp:\n.*error"):
        native.parallel_copy(torch.zeros(3))
