"""EVTP checkpoints across the two packages: the port reads what
``everyvoice_tpu.train.save_checkpoint`` writes into the same arrays, and the
JAX package's ``load_checkpoint`` reads what the port writes. Exact equality:
both sides move raw bytes."""

import numpy as np
import pytest

import jax
from flax import serialization

from everyvoice_tpu.train.checkpoint import load_checkpoint as jax_load
from everyvoice_tpu.train.checkpoint import save_checkpoint as jax_save
from everyvoice_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_checkpoint_header,
    save_checkpoint,
)
from everyvoice_tpu_torch.utils import msgpack_lite


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "Dense_0": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                        "bias": np.zeros((4,), np.float32)},
            "ids": np.arange(7, dtype=np.int32),
            "Nested_1": {"deep": {"x": rng.standard_normal((2, 2, 2)).astype(np.float64)}},
            "scalar": np.float32(1.5),
        },
        "step": 3,
    }


def _assert_same(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_port_reads_jax_checkpoint(tmp_path):
    tree = _tree()
    path = jax_save(tmp_path / "a.ckpt", "HiFiGANGenerator", {"model": {"k": 1}}, tree,
                    step=5, speaker2id={"s": 0})
    got = load_checkpoint(path)
    want = jax_load(path)
    assert got["model_info"] == want["model_info"]
    assert got["hyper_parameters"] == want["hyper_parameters"]
    assert got["global_step"] == 5
    _assert_same(got["state_dict"], want["state_dict"])


def test_jax_reads_port_checkpoint(tmp_path):
    tree = _tree(1)
    path = save_checkpoint(tmp_path / "b.ckpt", "FastSpeech2", {"model": {}}, tree,
                           lang2id={"default": 0})
    got = jax_load(path)
    assert got["model_info"]["name"] == "FastSpeech2"
    assert got["hyper_parameters"]["lang2id"] == {"default": 0}
    _assert_same(got["state_dict"], tree)


def test_writer_is_byte_identical_to_jax(tmp_path):
    args = ("FastSpeech2", {"model": {"max_length": 7}, "text": "é"}, _tree(2))
    kwargs = dict(step=4, epoch=1, lang2id={"x": 0}, stats={"pitch": {"mean": 1.0}})
    a = jax_save(tmp_path / "jax.ckpt", *args, **kwargs)
    b = save_checkpoint(tmp_path / "port.ckpt", *args, **kwargs)
    assert a.read_bytes() == b.read_bytes()


def test_encoder_is_byte_identical_to_flax():
    # flax's serializer sorts keys, so the port's writer sorts them first.
    tree = {"state_dict": {"a": {"bias": np.ones(2), "kernel": np.eye(2)}, "b": np.arange(3)}}
    assert msgpack_lite.packb(tree) == serialization.msgpack_serialize(tree)


@pytest.mark.parametrize("value", [
    None, True, False, 0, 127, 128, 255, 65535, 2**32, -1, -32, -33, -129, -2**40,
    1.25, "", "x" * 31, "y" * 32, "z" * 300, b"\x00" * 70000, [1, [2, {"a": None}]],
    {"k" * 20: list(range(20))},
])
def test_codec_matches_msgpack(value):
    import msgpack

    packed = msgpack_lite.packb(value)
    assert packed == msgpack.packb(value, use_bin_type=True)
    assert msgpack_lite.unpackb(packed) == msgpack.unpackb(packed, raw=False)


def test_bfloat16_leaves_decode_to_float32():
    import jax.numpy as jnp

    x = np.asarray(jnp.asarray([1.0, -2.5, 3.0e-3], jnp.bfloat16))
    got = msgpack_lite.unpackb(serialization.msgpack_serialize({"x": x}))["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.astype(np.float32))


def test_version_gate_and_magic(tmp_path):
    path = save_checkpoint(tmp_path / "c.ckpt", "FastSpeech2", {}, {"a": np.zeros(1)})
    assert load_checkpoint_header(path)["model_info"]["version"] == "1.0"
    raw = path.read_bytes().replace(b'"version": "1.0"', b'"version": "2.0"')
    newer = tmp_path / "newer.ckpt"
    newer.write_bytes(raw)
    with pytest.raises(ValueError, match="newer"):
        load_checkpoint(newer)
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"NOPE" + raw[4:])
    with pytest.raises(ValueError, match="not an everyvoice_tpu checkpoint"):
        load_checkpoint_header(bad)
