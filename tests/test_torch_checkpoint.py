"""The port's checkpoint I/O (checkpoint/io.py) and Weibull checkpoint
manager (checkpoint/manager.py) against the JAX package's: round trips,
the JAX leaf order, files written by either package restored by the other
equal by bits (a bf16 leaf included, read without ``ml_dtypes``), every
corruption mode named, and the manager's adaptive interval and verified
fallback, after ``tests/test_checkpoint.py``."""
import collections
import os
import subprocess
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import msgpack

from repro.checkpoint import io as jio

from repro_torch import faults
from repro_torch.checkpoint import io
from repro_torch.checkpoint.io import CheckpointCorruptError
from repro_torch.checkpoint.manager import CheckpointManager

Pair = collections.namedtuple("Pair", ["zeta", "alpha"])


def _tree():
    """Nested dicts (keys out of order), a NamedTuple (fields out of
    alphabetical order), a list, None, f32 / bf16 / int32 / int8 / bool."""
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
                  "a": torch.tensor(7, dtype=torch.int32)},
            "nt": Pair(zeta=torch.tensor([-1, 0, 1], dtype=torch.int8),
                       alpha=torch.tensor([True, False])),
            "lst": [torch.ones(2), None, torch.zeros((1, 2))]}


def _jax_tree(tree):
    """The same structure with JAX arrays of the same dtypes and bits."""
    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.to(torch.float32).numpy()).astype(
                jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return jax.tree.map(conv, tree, is_leaf=torch.is_tensor)


def _bits(x) -> bytes:
    if torch.is_tensor(x):
        x = x.to(torch.float32) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    a = np.asarray(x)
    return (a.astype(np.float32) if a.dtype.name == "bfloat16" else a
            ).tobytes()


def test_io_roundtrip(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ckpt.msgpack")
    io.save(path, tree)
    back = io.restore(path, tree)
    assert isinstance(back["nt"], Pair) and back["lst"][1] is None
    assert list(back) == list(tree) and list(back["b"]) == list(tree["b"])
    for x, y in zip(io.flatten(tree), io.flatten(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_io_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "c.msgpack")
    io.save(path, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        io.restore(path, {"a": torch.ones(4)})
    with pytest.raises(ValueError, match="leaves"):
        io.restore(path, {"a": torch.ones(3), "b": torch.ones(1)})


def test_leaf_order_is_jax():
    tree = _tree()
    got = [_bits(l) for l in io.flatten(tree)]
    want = [_bits(l) for l in jax.tree.leaves(_jax_tree(tree))]
    assert got == want


def test_jax_written_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree()
    path = str(tmp_path / "jax.msgpack")
    jio.save(path, _jax_tree(tree))
    back = io.restore(path, jax.tree.map(torch.zeros_like, tree,
                                         is_leaf=torch.is_tensor))
    for x, y in zip(io.flatten(tree), io.flatten(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert back["b"]["c"].dtype == torch.bfloat16


def test_port_written_checkpoint_restores_in_jax(tmp_path):
    tree = _tree()
    path = str(tmp_path / "port.msgpack")
    io.save(path, tree)
    jtree = _jax_tree(tree)
    back = jio.restore(path, jax.tree.map(jnp.zeros_like, jtree))
    assert back["b"]["c"].dtype == jnp.bfloat16
    assert [_bits(l) for l in jax.tree.leaves(back)] == \
        [_bits(l) for l in jax.tree.leaves(jtree)]


def test_restore_keeps_the_like_device_and_dtype(tmp_path):
    path = str(tmp_path / "d.msgpack")
    io.save(path, {"q": torch.tensor([1, -2], dtype=torch.int8)})
    back = io.restore(path, {"q": np.zeros(2)})     # numpy like: CPU tensor
    assert back["q"].dtype == torch.int8 and back["q"].device.type == "cpu"


def _saved(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    path = str(tmp_path / "c.msgpack")
    io.save(path, tree)
    return path, tree


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _flip(path):
    at = os.path.getsize(path) - 8
    with open(path, "r+b") as f:
        f.seek(at)
        c = f.read(1)
        f.seek(at)
        f.write(bytes([c[0] ^ 0x01]))


def _stale_digest(path):
    with open(path, "rb") as f:
        outer = msgpack.unpackb(f.read(), raw=False)
    outer["sha256"] = "0" * 64
    with open(path, "wb") as f:
        f.write(msgpack.packb(outer, use_bin_type=True))


def _not_envelope(path):
    with open(path, "wb") as f:
        f.write(msgpack.packb({"something": "else"}, use_bin_type=True))


@pytest.mark.parametrize("corrupt,match", [
    (_truncate, "c.msgpack"), (_flip, "c.msgpack"),
    (_stale_digest, "digest mismatch"), (_not_envelope, "envelope")],
    ids=["truncated", "bit-flip", "stale-digest", "not-an-envelope"])
def test_corruption_is_named(corrupt, match, tmp_path):
    """Every corruption mode raises ``CheckpointCorruptError`` naming the
    path; ``verify`` is the matching non-raising probe."""
    path, tree = _saved(tmp_path)
    corrupt(path)
    with pytest.raises(CheckpointCorruptError, match=match) as ei:
        io.restore(path, tree)
    assert ei.value.path == path
    assert not io.verify(path)


def test_legacy_pre_digest_checkpoint_still_restores(tmp_path):
    legacy = {"treedef": "PyTreeDef({'w': *})",
              "leaves": [{"dtype": "float32", "shape": [2, 2],
                          "data": np.ones((2, 2), np.float32).tobytes()}]}
    path = str(tmp_path / "v1.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack.packb(legacy, use_bin_type=True))
    back = io.restore(path, {"w": torch.zeros(2, 2)})
    assert torch.equal(back["w"], torch.ones(2, 2))
    assert io.verify(path)


def test_verify_missing_file_false(tmp_path):
    assert not io.verify(str(tmp_path / "never.msgpack"))


def test_injected_faults_fire_at_their_sites(tmp_path):
    """``ckpt_write`` fires before the rename (the old file is intact);
    ``ckpt_read`` fails the restore and ``verify`` reports False."""
    path, tree = _saved(tmp_path)
    before = open(path, "rb").read()
    with faults.FaultInjector(faults.FaultSpec(ckpt_write_p=1.0)).scoped():
        with pytest.raises(faults.InjectedFault):
            io.save(path, {"w": torch.zeros(2, 3)})
    assert open(path, "rb").read() == before
    with faults.FaultInjector(faults.FaultSpec(ckpt_read_p=1.0)).scoped():
        with pytest.raises(faults.InjectedFault):
            io.restore(path, tree)
        assert not io.verify(path)
    assert torch.equal(io.restore(path, tree)["w"], tree["w"])


def test_manager_latest_good_and_fallback_equal_by_bits(tmp_path):
    """Corrupting the canonical artifact degrades restore to the newest
    verified history copy, with the same bytes."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(
        np.float32))}
    mgr.save(tree, now=0.0)
    with open(mgr.path(), "r+b") as f:
        f.seek(20)
        c = f.read(1)
        f.seek(20)
        f.write(bytes([c[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorruptError):
        mgr.restore({"w": torch.zeros(8, 4)})
    good = mgr.latest_good()
    assert good is not None and good != mgr.path()
    back = mgr.restore({"w": torch.zeros(8, 4)}, fallback=True)
    assert back["w"].numpy().tobytes() == tree["w"].numpy().tobytes()


def test_manager_adapts_interval_and_prunes(tmp_path):
    """As the JAX package's manager: failures every 3 s shrink the
    interval below the prior, the same interval in both packages, and
    the history keeps the newest ``keep``."""
    from repro.checkpoint.manager import CheckpointManager as JManager
    mgr = CheckpointManager(str(tmp_path / "port"), total_time=1000.0,
                            recovery_time=5.0, keep=2)
    jmgr = JManager(str(tmp_path / "jax"), total_time=1000.0,
                    recovery_time=5.0, keep=2)
    before = mgr.interval
    for t in np.cumsum(np.full(20, 3.0)):
        mgr.record_failure(float(t))
        jmgr.record_failure(float(t))
    assert mgr.interval < before and mgr.interval == jmgr.interval
    tree = {"w": torch.ones(3)}
    assert mgr.maybe_save(tree, now=0.0)
    assert not mgr.maybe_save(tree, now=mgr.interval * 0.1)
    assert mgr.maybe_save(tree, now=mgr.interval * 1.1)
    assert mgr.maybe_save(tree, now=mgr.interval * 2.2)
    assert len(mgr.history()) == 2 and mgr.saves == 3
    back = mgr.restore({"w": torch.zeros(3)})
    assert torch.equal(back["w"], torch.ones(3))
    assert os.path.exists(mgr.path())
    with pytest.raises(ValueError, match="keep"):
        CheckpointManager(str(tmp_path / "k"), keep=0)


def test_msgpack_is_imported_only_when_a_file_is_read_or_written(tmp_path):
    """The package, sessions and the I/O module import without msgpack
    (the card's machine lists no msgpack among its installs)."""
    code = ("import sys; sys.modules['msgpack'] = None\n"
            "import repro_torch\n"
            "from repro_torch.checkpoint import io, manager\n"
            "from repro_torch.api import session\n"
            "try:\n"
            "    io.save(sys.argv[1], {})\n"
            "except ImportError:\n"
            "    print('refused')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "x.msgpack")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"
