"""Port vs reference: bit packing and the record store (tolerance zero).

The same numpy inputs go through ``repro.db`` (JAX) and ``repro_torch.db``
(torch, CPU); results are compared as numpy arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.db import make_synthetic_store as ref_make_store
from repro.db import packing as ref_packing
from repro_torch.db import make_synthetic_store, packing
from repro_torch.db.store import RecordStore

from _torch_parity import CPU, seeded_bytes, words_n2t, words_t2n

BIT_SHAPES = [(1, 1), (3, 31), (2, 32), (5, 33), (4, 64), (7, 100), (2, 3, 45)]


def _bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", BIT_SHAPES)
def test_pack_bits_equals_reference(shape):
    bits = _bits(shape, seed=len(shape) + shape[-1])
    want = np.asarray(ref_packing.pack_bits(jnp.asarray(bits)))
    got = packing.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(words_t2n(got), want)


@pytest.mark.parametrize("shape", BIT_SHAPES)
def test_unpack_bits_equals_reference_and_round_trips(shape):
    bits = _bits(shape, seed=shape[-1])
    words = packing.pack_bits(torch.from_numpy(bits))
    back = packing.unpack_bits(words, shape[-1])
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), bits)
    want = np.asarray(
        ref_packing.unpack_bits(jnp.asarray(words_t2n(words)), shape[-1])
    )
    np.testing.assert_array_equal(back.numpy(), want)


def test_pack_bits_bit31_set():
    """Bit 31 is the int32 sign bit: packing must not overflow and
    unpacking must mask the arithmetic shift's sign fill."""
    bits = np.zeros((3, 64), np.uint8)
    bits[0, 31] = 1
    bits[1, :] = 1
    bits[2, 31] = bits[2, 63] = bits[2, 0] = 1
    words = packing.pack_bits(torch.from_numpy(bits))
    want = np.asarray(ref_packing.pack_bits(jnp.asarray(bits)))
    np.testing.assert_array_equal(words_t2n(words), want)
    assert words_t2n(words)[0, 0] == 2**31
    assert words_t2n(words)[1].tolist() == [2**32 - 1, 2**32 - 1]
    np.testing.assert_array_equal(packing.unpack_bits(words).numpy(), bits)


@pytest.mark.parametrize("value", [0, 1, 2**31, 2**32 - 1, 0xDEADBEEF])
def test_unpack_every_word_value_class(value):
    words = words_n2t(np.array([[value]], np.uint32))
    want = np.asarray(ref_packing.unpack_bits(jnp.asarray([[value]], jnp.uint32)))
    np.testing.assert_array_equal(packing.unpack_bits(words).numpy(), want)


@pytest.mark.parametrize("n,nbytes", [(1, 1), (4, 3), (5, 4), (3, 129), (9, 1536)])
def test_pack_bytes_np_equals_reference(n, nbytes):
    raw = seeded_bytes(n, nbytes, seed=n)
    got = packing.pack_bytes_np(raw)
    np.testing.assert_array_equal(got, ref_packing.pack_bytes_np(raw))
    np.testing.assert_array_equal(packing.unpack_bytes_np(got, nbytes), raw)


@pytest.mark.parametrize("bits,words", [(1, 1), (32, 1), (33, 2), (12288, 384)])
def test_words_per_record(bits, words):
    assert packing.words_per_record(bits) == words
    assert ref_packing.words_per_record(bits) == words


def test_words_per_record_rejects_nonpositive():
    with pytest.raises(ValueError):
        packing.words_per_record(0)


@pytest.mark.parametrize("n,rb,seed", [(64, 8, 0), (100, 12, 1), (37, 129, 2),
                                       (300, 50, 3), (1, 1, 4)])
def test_synthetic_store_bytes_identical_to_reference(n, rb, seed):
    ref = ref_make_store(n, rb, seed=seed)
    got = make_synthetic_store(n, rb, seed=seed, device="cpu")
    assert (got.n, got.words, got.record_bits, got.nbytes) == (
        ref.n, ref.words, ref.record_bits, ref.nbytes)
    np.testing.assert_array_equal(words_t2n(got.packed), np.asarray(ref.packed))
    for i in (0, n // 2, n - 1):
        np.testing.assert_array_equal(got.record_bytes(i), ref.record_bytes(i))
        np.testing.assert_array_equal(
            got.record_bytes(i), seeded_bytes(n, rb, seed)[i])


@pytest.mark.parametrize("n,rb", [(16, 4), (33, 13), (8, 129)])
def test_bitplanes_equal_reference(n, rb):
    ref = ref_make_store(n, rb, seed=5)
    got = make_synthetic_store(n, rb, seed=5, device="cpu")
    planes = got.bitplanes()
    assert planes.dtype == torch.uint8  # the port keeps planes in bytes
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(ref.bitplanes()).astype(np.uint8))
    np.testing.assert_array_equal(
        words_t2n(packing.packed_from_bitplanes(planes.float())),
        np.asarray(ref.packed))


def test_store_is_frozen_and_int32():
    store = make_synthetic_store(8, 4, device="cpu")
    assert store.packed.dtype == torch.int32 and store.device == CPU
    with pytest.raises(Exception):
        store.record_bits = 1


def test_from_bytes_matches_reference():
    raw = seeded_bytes(10, 7, seed=9)
    got = RecordStore.from_bytes(raw, device="cpu")
    from repro.db import RecordStore as RefStore

    np.testing.assert_array_equal(
        words_t2n(got.packed), np.asarray(RefStore.from_bytes(raw).packed))


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_synthetic_store(4, 4)
