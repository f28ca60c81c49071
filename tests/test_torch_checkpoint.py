"""The port's checkpoint layer (``repro_torch.checkpoint.checkpoint``) on
the CPU: the scenarios of the reference's ``tests/test_checkpoint.py``
(atomicity, manifests, restore, placement with ``device=`` in place of
``shardings=``, the per-array crc32), and two cross-package tests, each
bitwise: a checkpoint the port writes restores through the reference's
``restore_checkpoint``, and the reverse; the same both ways for trees
with bf16 leaves (stored as the reference stores them, 2-byte void
values), and the reference's own failure to restore those into a
template.
"""

import json
import os
from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rckpt
from repro_torch.checkpoint.checkpoint import (CheckpointCorrupt, _crc32,
                                               _flatten_with_keys,
                                               latest_step, list_steps,
                                               restore_checkpoint,
                                               save_checkpoint)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                           rng.standard_normal((4, 4))).float(),
                       "b": torch.from_numpy(rng.standard_normal(4)).float()},
            "opt": {"m": torch.zeros((4, 4), dtype=torch.float32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    return list(_flatten_with_keys(tree).values())


def _bitwise(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 7, tree, metadata={"note": "x"})
    assert os.path.isdir(path)
    restored, meta = restore_checkpoint(str(tmp_path), 7, tree)
    assert meta == {"note": "x"}
    assert restored.keys() == tree.keys()
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        _bitwise(a.numpy(), b.numpy())


def test_latest_step_and_list(tmp_path):
    for s in (3, 10, 5):
        save_checkpoint(str(tmp_path), s, _tree(s))
    assert list_steps(str(tmp_path)) == [3, 5, 10]
    assert latest_step(str(tmp_path)) == 10


def test_partial_write_is_invisible(tmp_path):
    """A directory without MANIFEST (crashed save) is ignored."""
    save_checkpoint(str(tmp_path), 1, _tree())
    bad = tmp_path / "step_0000000002"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) == 1


def test_overwrite_same_step(tmp_path):
    t1, t2 = _tree(1), _tree(2)
    save_checkpoint(str(tmp_path), 4, t1)
    save_checkpoint(str(tmp_path), 4, t2)
    restored, _ = restore_checkpoint(str(tmp_path), 4, t2)
    _bitwise(restored["params"]["w"].numpy(), t2["params"]["w"].numpy())


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    bad_template = _tree()
    bad_template["params"]["w"] = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 1, bad_template)


def test_missing_leaf_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2),
                                              "b": torch.zeros(2)})


def test_restore_with_device_placement(tmp_path):
    """``device=`` places the restored tensors (the reference's
    ``shardings=``), with the template's dtypes, and a manifest-driven
    restore with ``device=`` returns tensors too."""
    tree = {"w": torch.ones((8, 2), dtype=torch.float32)}
    save_checkpoint(str(tmp_path), 2, tree)
    restored, _ = restore_checkpoint(str(tmp_path), 2, tree, device="cpu")
    assert restored["w"].device == torch.device("cpu")
    _bitwise(restored["w"].numpy(), tree["w"].numpy())
    cast, _ = restore_checkpoint(str(tmp_path), 2,
                                 {"w": torch.ones((8, 2), dtype=torch.float64)})
    assert cast["w"].dtype == torch.float64
    flat, _ = restore_checkpoint(str(tmp_path), 2, device="cpu")
    assert isinstance(flat["w"], torch.Tensor)
    flat, _ = restore_checkpoint(str(tmp_path), 2)
    assert isinstance(flat["w"], np.ndarray)


def test_manifest_contents(tmp_path):
    save_checkpoint(str(tmp_path), 9, _tree(), metadata={"cfg": "smollm"})
    with open(tmp_path / "step_0000000009" / "MANIFEST.json") as f:
        man = json.load(f)
    assert man["step"] == 9
    assert man["metadata"]["cfg"] == "smollm"
    assert man["keys"]["params/w"]["shape"] == [4, 4]
    assert isinstance(man["keys"]["params/w"]["crc32"], int)


def test_flipped_payload_bytes_raise_checkpoint_corrupt(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 1, tree)
    npz = os.path.join(path, "arrays.npz")
    data = bytearray(open(npz, "rb").read())
    for off in range(len(data) // 2, len(data) // 2 + 8):
        data[off] ^= 0xFF
    with open(npz, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(CheckpointCorrupt):
        restore_checkpoint(str(tmp_path), 1, tree)


def test_truncated_payload_raises_checkpoint_corrupt(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 1, tree)
    npz = os.path.join(path, "arrays.npz")
    data = open(npz, "rb").read()
    with open(npz, "wb") as f:
        f.write(data[: len(data) // 3])
    with pytest.raises(CheckpointCorrupt, match="unreadable|crc32"):
        restore_checkpoint(str(tmp_path), 1, tree)


def test_manifest_listed_array_missing_from_payload(tmp_path):
    tree = {"a": torch.zeros(3, dtype=torch.float64),
            "b": torch.ones(3, dtype=torch.float64)}
    path = save_checkpoint(str(tmp_path), 2, tree)
    man_path = os.path.join(path, "MANIFEST.json")
    with open(man_path) as f:
        man = json.load(f)
    man["keys"]["ghost"] = {"shape": [3], "dtype": "float64", "crc32": 0}
    with open(man_path, "w") as f:
        json.dump(man, f)
    with pytest.raises(CheckpointCorrupt, match="ghost"):
        restore_checkpoint(str(tmp_path), 2, tree)


def test_pre_checksum_manifest_restores_unverified(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 3, tree)
    man_path = os.path.join(path, "MANIFEST.json")
    with open(man_path) as f:
        man = json.load(f)
    for info in man["keys"].values():
        del info["crc32"]
    with open(man_path, "w") as f:
        json.dump(man, f)
    restored, _ = restore_checkpoint(str(tmp_path), 3, tree)
    for a, b in zip(_leaves(tree), _leaves(restored)):
        _bitwise(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# The port's own rules: keys, crc32, bf16
# ---------------------------------------------------------------------------

def test_keys_crc32_and_bf16_as_specified(tmp_path):
    """Leaf keys are the reference's (sorted dict keys, sequence indices,
    namedtuple fields, ``None`` holds no leaf), the crc32 is the
    reference's ``tobytes`` one, and a bf16 leaf is stored as the
    reference stores it: 2-byte void values holding its bits, manifest
    dtype ``bfloat16``, the crc32 over those bytes; it restores bitwise."""
    Pair = namedtuple("Pair", "left right")
    tree = {"z": [np.zeros(1), (np.ones(2), None)], "a": Pair(1.0, 2),
            "c": {"x.": np.arange(3), "'q'": np.ones(1)},
            "n": {2: np.zeros(1), 1: np.ones(1)}}
    assert list(_flatten_with_keys(tree)) == list(
        rckpt._flatten_with_keys(tree))
    for a in (np.arange(12.0).reshape(3, 4)[:, ::2], np.asarray(7, np.int32),
              np.zeros(0)):
        assert _crc32(a) == rckpt._crc32(a)
    w = torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, {"w": w})
    with open(tmp_path / "step_0000000001" / "MANIFEST.json") as f:
        info = json.load(f)["keys"]["w"]
    bits = w.view(torch.int16).numpy()
    assert info["dtype"] == "bfloat16" and info["shape"] == [3]
    assert info["crc32"] == rckpt._crc32(bits)
    stored, _ = restore_checkpoint(str(tmp_path), 1)
    assert stored["w"].dtype == np.dtype("V2")
    assert stored["w"].tobytes() == bits.tobytes()
    back, _ = restore_checkpoint(str(tmp_path), 1, {"w": w})
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))


# ---------------------------------------------------------------------------
# Across the packages, bitwise both ways
# ---------------------------------------------------------------------------

def _nested(seed):
    rng = np.random.default_rng(seed)
    return {"layer": {"w": rng.standard_normal((5, 3)),
                      "b": rng.standard_normal(3).astype(np.float32)},
            "blocks": [rng.standard_normal(4),
                       rng.integers(-9, 9, (2, 2)).astype(np.int32)],
            "step": np.asarray(11, np.int64)}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    want = _nested(1)
    tree = {"layer": {k: torch.from_numpy(v) for k, v in
                      want["layer"].items()},
            "blocks": [torch.from_numpy(v) for v in want["blocks"]],
            "step": torch.from_numpy(want["step"])}
    save_checkpoint(str(tmp_path), 5, tree, metadata={"by": "port"})
    template = {"layer": {k: jnp.asarray(v) for k, v in
                          want["layer"].items()},
                "blocks": [jnp.asarray(v) for v in want["blocks"]],
                "step": jnp.asarray(want["step"])}
    got, meta = rckpt.restore_checkpoint(str(tmp_path), 5, template)
    assert meta == {"by": "port"}
    for a, b in zip(_leaves(want), _leaves(got)):
        _bitwise(b, a)
    flat, _ = rckpt.restore_checkpoint(str(tmp_path), 5)
    assert list(flat) == list(_flatten_with_keys(want))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    want = _nested(2)
    rckpt.save_checkpoint(str(tmp_path), 6,
                          {"layer": {k: jnp.asarray(v) for k, v in
                                     want["layer"].items()},
                           "blocks": [jnp.asarray(v) for v in
                                      want["blocks"]],
                           "step": jnp.asarray(want["step"])},
                          metadata={"by": "reference"})
    template = {"layer": {k: torch.from_numpy(v) for k, v in
                          want["layer"].items()},
                "blocks": [torch.from_numpy(v) for v in want["blocks"]],
                "step": torch.from_numpy(want["step"])}
    got, meta = restore_checkpoint(str(tmp_path), 6, template)
    assert meta == {"by": "reference"}
    for a, b in zip(_leaves(want), _leaves(got)):
        _bitwise(b.numpy(), a)


# ---------------------------------------------------------------------------
# bf16 leaves across the packages (training checkpoints)
# ---------------------------------------------------------------------------

def _bf16_tree(seed):
    """{name: f32 array} whose "w" and "b" leaves are stored as bf16; the
    bf16 values as their uint16 bits (what both packages must agree on)."""
    rng = np.random.default_rng(seed)
    w32 = rng.standard_normal((5, 3)).astype(np.float32)
    b32 = rng.standard_normal(4).astype(np.float32)
    m = rng.standard_normal((5, 3)).astype(np.float32)
    return w32, b32, m


def test_reference_bf16_checkpoint_restores_bitwise_in_the_port(tmp_path):
    """A tree the reference writes with bf16 (``ml_dtypes``) and f32
    leaves: the port restores it bitwise into bf16 and f32 tensors, every
    checksum verified (a flipped byte of a bf16 leaf raises)."""
    w32, b32, m = _bf16_tree(3)
    ref_tree = {"params": {"w": jnp.asarray(w32, jnp.bfloat16),
                           "b": jnp.asarray(b32, jnp.bfloat16)},
                "opt": {"m": jnp.asarray(m)}}
    rckpt.save_checkpoint(str(tmp_path), 4, ref_tree)
    template = {"params": {"w": torch.zeros((5, 3), dtype=torch.bfloat16),
                           "b": torch.zeros(4, dtype=torch.bfloat16)},
                "opt": {"m": torch.zeros((5, 3))}}
    got, _ = restore_checkpoint(str(tmp_path), 4, template)
    for k in ("w", "b"):
        want_bits = np.asarray(ref_tree["params"][k]).view(np.uint16)
        assert got["params"][k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got["params"][k].view(torch.int16).numpy().view(np.uint16),
            want_bits)
    _bitwise(got["opt"]["m"].numpy(), m)
    # the port writes the same bytes and manifest for the same tree
    save_checkpoint(str(tmp_path / "port"), 4, got)
    for name in ("MANIFEST.json",):
        a = json.load(open(tmp_path / "step_0000000004" / name))["keys"]
        b = json.load(open(tmp_path / "port" / "step_0000000004" / name))[
            "keys"]
        assert a == b
    path = tmp_path / "step_0000000004" / "arrays.npz"
    raw = bytearray(path.read_bytes())
    i = raw.index(np.asarray(ref_tree["params"]["w"]).tobytes()[:8])
    raw[i] ^= 0x01
    path.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorrupt):
        restore_checkpoint(str(tmp_path), 4, template)


def test_port_bf16_checkpoint_restores_bitwise_in_the_reference(tmp_path):
    """A tree the port writes with bf16 and f32 leaves: the reference's
    manifest-driven restore verifies every crc32 and reads the bf16 bits
    back (as ``ml_dtypes.bfloat16``) bitwise."""
    import ml_dtypes
    w32, b32, m = _bf16_tree(4)
    tree = {"params": {"w": torch.from_numpy(w32).bfloat16(),
                       "b": torch.from_numpy(b32).bfloat16()},
            "opt": {"m": torch.from_numpy(m)}}
    save_checkpoint(str(tmp_path), 9, tree, metadata={"by": "port"})
    flat, meta = rckpt.restore_checkpoint(str(tmp_path), 9)
    assert meta == {"by": "port"}
    for k in ("w", "b"):
        got = flat[f"params/{k}"].view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(
            got.view(np.uint16),
            tree["params"][k].view(torch.int16).numpy().view(np.uint16))
        np.testing.assert_array_equal(got.astype(np.float32),
                                      tree["params"][k].float().numpy())
    _bitwise(flat["opt/m"], m)


def test_reference_cannot_restore_bf16_into_a_template(tmp_path):
    """Pins a fault of the reference (ROADMAP Queue C): its own bf16
    checkpoint does not restore into a template, since numpy cannot cast
    the stored 2-byte void values to bfloat16; the port restores it."""
    tree = {"w": jnp.asarray([1.5, -2.0], jnp.bfloat16)}
    rckpt.save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError):
        rckpt.restore_checkpoint(str(tmp_path), 1, tree)
    got, _ = restore_checkpoint(str(tmp_path), 1, {
        "w": torch.zeros(2, dtype=torch.bfloat16)})
    assert got["w"].tolist() == [1.5, -2.0]
