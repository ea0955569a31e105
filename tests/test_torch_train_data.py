"""The training slice's host data path against the JAX package: the record
codec (byte-equal shards both ways, each package reads the other's) and
``ShardIterator`` / ``load_holdout`` (bit-equal batches for a seed, holdout
split included), and ``prefetch_to_device`` on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from sequitr_tpu.data import prefetch as jax_prefetch
from sequitr_tpu.data import records as jax_records
from sequitr_tpu.pipeline import fit as jax_fit
from sequitr_tpu_torch import native
from sequitr_tpu_torch.data import prefetch, records
from sequitr_tpu_torch.pipeline import fit


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _examples(n, seed, spatial=(12, 10), channels=None, weights=True):
    rng = np.random.default_rng(seed)
    img_shape = spatial + ((channels,) if channels else ())
    out = []
    for _ in range(n):
        img = rng.random(img_shape).astype(np.float32)
        lab = rng.integers(0, 3, spatial).astype(np.int32)
        w = rng.random(spatial).astype(np.float32) if weights else None
        out.append((img, lab, w))
    return out


def _write(mod, prefix, examples, **kw):
    return mod.write_segmentation_shards(
        prefix, (mod.SegExample(*ex) for ex in examples), **kw
    )


@pytest.mark.parametrize("compression", [None, "gzip"])
@pytest.mark.parametrize("kind", ["2d", "multichannel", "3d_no_weights"])
def test_shards_byte_equal_and_cross_readable(tmp_path, compression, kind):
    spatial, channels, weights = {
        "2d": ((12, 10), None, True),
        "multichannel": ((8, 6), 2, True),
        "3d_no_weights": ((3, 8, 6), None, False),
    }[kind]
    examples = _examples(7, seed=1, spatial=spatial, channels=channels, weights=weights)
    # one prefix in two directories: a gzip header carries the file's name
    os.makedirs(tmp_path / "ours")
    os.makedirs(tmp_path / "theirs")
    ours = _write(records, str(tmp_path / "ours" / "train"), examples, shard_size=3, compression=compression)
    theirs = _write(
        jax_records, str(tmp_path / "theirs" / "train"), examples, shard_size=3, compression=compression
    )
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    assert len(ours) == 3
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    for reader, paths in ((jax_records, ours), (records, theirs)):
        got = list(reader.read_segmentation_examples(paths))
        assert len(got) == len(examples)
        for ex, (img, lab, w) in zip(got, examples):
            np.testing.assert_array_equal(ex.image, img)
            np.testing.assert_array_equal(ex.labels, lab)
            if w is None:
                assert ex.weights is None
            else:
                np.testing.assert_array_equal(ex.weights, w)


def test_crc_and_example_codec():
    data = np.random.default_rng(0).integers(0, 256, 1000).astype(np.uint8).tobytes()
    assert records.crc32c(data) == jax_records.crc32c(data) == native.crc32c(data)
    assert records.crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value
    feats = {"a": b"x", "b": [1, -2, 3], "c": [0.5, 2.5], "d": np.arange(4, dtype=np.float32)}
    assert records.encode_example(feats) == jax_records.encode_example(feats)
    assert records.decode_example(jax_records.encode_example(feats)) == jax_records.decode_example(
        jax_records.encode_example(feats)
    )


def test_corrupt_record_is_an_ioerror(tmp_path):
    (path,) = _write(records, str(tmp_path / "x"), _examples(1, seed=2))
    blob = bytearray(open(path, "rb").read())
    blob[20] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        list(records.read_records(path))


@pytest.mark.parametrize("holdout_every", [0, 3])
def test_shard_iterator_bit_equal(tmp_path, holdout_every):
    """The same shards and seed give the same batches in the same order (a
    shuffle buffer smaller than the data, several epochs), and the same
    holdout split."""
    examples = _examples(20, seed=3)
    paths = _write(records, str(tmp_path / "train"), examples, shard_size=6)
    kw = dict(batch_size=4, seed=5, shuffle_buffer=7, holdout_every=holdout_every)
    ours = iter(prefetch.ShardIterator(paths, fit._decode_seg, **kw))
    theirs = iter(jax_prefetch.ShardIterator(paths, jax_fit._decode_seg, **kw))
    for _ in range(12):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == {"image", "labels", "weights"}
        for k in a:
            assert a[k].dtype == np.asarray(b[k]).dtype
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    ha = prefetch.load_holdout(paths, fit._decode_seg, holdout_every, limit=4)
    hb = jax_prefetch.load_holdout(paths, jax_fit._decode_seg, holdout_every, limit=4)
    if holdout_every == 0:
        assert ha is None and hb is None
    else:
        for k in hb:
            np.testing.assert_array_equal(ha[k], np.asarray(hb[k]))


def test_prefetch_to_device_keeps_order_and_values():
    batches = [{"x": np.full((2, 3), i, np.float32), "y": np.arange(i, i + 2)} for i in range(5)]
    got = list(prefetch.prefetch_to_device(iter(batches), depth=2, device="cpu"))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
        np.testing.assert_array_equal(b["y"].numpy(), batches[i]["y"])
