"""The port's atomic checkpoints (paddle_tpu_torch.distributed.resilience
.atomic_ckpt) and resumable data position (.data) held to the JAX
package's on the CPU.

- the same trees written by both packages give byte-equal snapshots: the
  ``.bin`` bytes, shapes, dtype names, crc32s, meta and the treedef string
  (built by jax) are equal, and each package loads the other's snapshot
  into its own template;
- torn writes, checksum mismatches, truncated and missing files, keep-N
  GC, same-step collisions and structural mismatches behave as the
  reference's (the reference's tests/test_resilience.py, case by case);
- ``ResumableIterator`` gives the reference's ``state_dict`` at every
  position, with epoch rollover, native (loader-level) skips and resume
  exactly at an epoch's end;
- the paths that wait for other queue items raise naming their queue."""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.distributed.resilience import ResumableIterator as JIter
from paddle_tpu.distributed.resilience import atomic_ckpt as jac
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.distributed.resilience import ResumableIterator
from paddle_tpu_torch.distributed.resilience import atomic_ckpt as ac
from paddle_tpu_torch.models import llama as tl
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=16,
             ffn=64)


def _to_torch(x):
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _jtree_to_torch(tree):
    """A JAX tree as the port's: dicts/tuples mapped, TrainState rebuilt as
    the port's class, arrays as torch tensors."""
    if isinstance(tree, jl.TrainState):
        return tl.TrainState(*(_jtree_to_torch(c) for c in
                               (tree.params, tree.mu, tree.nu, tree.step)))
    if isinstance(tree, dict):
        return {k: _jtree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jtree_to_torch(v) for v in tree)
    if tree is None:
        return None
    return _to_torch(tree)


def _leaves_equal(a, b):
    la, lb = ac.flatten(a)[0], jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        y = np.asarray(y)
        assert str(x.dtype).replace("torch.", "") == y.dtype.name
        np.testing.assert_array_equal(x.float().numpy(),
                                      y.astype(np.float32).reshape(x.shape))


def _snapshot(root):
    path = ac.list_checkpoints(root)[-1][1]
    files = {n: open(os.path.join(path, n), "rb").read()
             for n in sorted(os.listdir(path))}
    return path, files


def _llama_trees(optimizer, param_dtype):
    cfg = jl.tiny_llama(**SIZES)
    js = jl.init_train_state(cfg, jax.random.PRNGKey(0),
                             optimizer=optimizer, param_dtype=param_dtype)
    jt = {"state": js, "rng": jax.random.PRNGKey(3)}
    return jt, _jtree_to_torch(jt)


TREES = {
    "mixed": lambda: (
        {"w": jnp.arange(12.0).reshape(3, 4), "k": jax.random.PRNGKey(7),
         "bf": jnp.full((5,), 2.5, jnp.bfloat16), "s": jnp.zeros(()),
         "i": jnp.arange(4, dtype=jnp.int32), "t": (jnp.ones(2), None),
         "l": [jnp.int8(3) * jnp.ones((2, 2), jnp.int8)]}),
    "llama_adamw": lambda: _llama_trees("adamw", jnp.float32),
    "llama_adafactor_bf16": lambda: _llama_trees("adafactor",
                                                 jnp.bfloat16),
}


def _trees(name):
    got = TREES[name]()
    if isinstance(got, tuple):
        return got
    return got, _jtree_to_torch(got)


@pytest.mark.parametrize("name", sorted(TREES))
def test_snapshots_byte_equal_and_cross_load(name, tmp_path):
    jt, tt = _trees(name)
    meta = {"step": 3, "loader": {"epoch": 1, "index": 2}, "tag": "x"}
    jac.save_checkpoint(jt, str(tmp_path / "j"), 3, meta=meta)
    ac.save_checkpoint(tt, str(tmp_path / "t"), 3, meta=meta)
    jpath, jfiles = _snapshot(str(tmp_path / "j"))
    tpath, tfiles = _snapshot(str(tmp_path / "t"))
    assert jfiles == tfiles
    manifest = json.loads(tfiles["manifest.json"])
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(jt))
    assert manifest["meta"] == meta
    # each package loads the other's snapshot into its own template
    got, man = ac.load_latest_valid(str(tmp_path / "j"), tt)
    assert man["meta"] == meta
    _leaves_equal(got, jt)
    jgot, _ = jac.load_latest_valid(str(tmp_path / "t"), jt)
    _leaves_equal(tt, jgot)


def test_treedef_of_tiny_llama_state_plus_rng_is_jax_s():
    jt, tt = _llama_trees("adamw", jnp.float32)
    want = str(jax.tree_util.tree_structure(jt))
    assert want.startswith("PyTreeDef({'rng': *, 'state': CustomNode("
                           "TrainState[None], [{'embed': *, 'final_norm': "
                           "*, 'layers': {'attn_norm': *,")
    assert ac.treedef_str(ac.flatten(tt)[1]) == want


def test_loaded_state_keeps_shapes_dtypes_devices_and_key_order(tmp_path):
    _, tt = _llama_trees("adafactor", jnp.bfloat16)
    ac.save_checkpoint(tt, str(tmp_path), 1)
    got, _ = ac.load_latest_valid(str(tmp_path), tt)
    st, want = got["state"], tt["state"]
    assert isinstance(st, tl.TrainState)
    assert st.step.shape == () and st.step.dtype == torch.int32
    assert list(st.params) == list(want.params)
    assert list(st.params["layers"]) == list(want.params["layers"])
    for a, b in zip(ac.flatten(st)[0], ac.flatten(want)[0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.device == b.device and torch.equal(a, b)
    assert got["rng"].dtype == torch.uint32


def test_atomic_roundtrip_with_meta(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "k": torch.tensor([0, 7], dtype=torch.uint32),
            "bf": torch.full((5,), 2.5, dtype=torch.bfloat16)}
    ac.save_checkpoint(tree, str(tmp_path), 3,
                       meta={"step": 3, "loader": {"epoch": 1}})
    tpl = {k: torch.zeros_like(v) for k, v in tree.items()}
    out, manifest = ac.load_latest_valid(str(tmp_path), tpl)
    for k in tree:
        assert torch.equal(out[k], tree[k])
    assert out["bf"].dtype == torch.bfloat16
    assert manifest["meta"] == {"step": 3, "loader": {"epoch": 1}}


def _die(i):
    if i >= 1:
        raise OSError("disk on fire")


def _fallbacks(pkg, mk, root):
    """The reference's torn-write, corrupt-newest, truncated and missing
    cases through one package: what each load returns (steps and first
    leaf), and what each validation raises."""
    out = []
    tree = {"a": mk(np.ones(4)), "b": mk(np.zeros((2, 2)))}
    pkg.save_checkpoint(tree, root, 1)
    with pytest.raises(OSError):
        pkg.save_checkpoint({"a": mk(np.full(4, 9.0)),
                             "b": mk(np.full((2, 2), 9.0))}, root, 2,
                            fail_hook=_die)
    out.append([s for s, _ in pkg.list_checkpoints(root)])
    got, man = pkg.load_latest_valid(root, tree)
    out.append((man["step"], np.asarray(got["a"]).tolist()))
    pkg.save_checkpoint({"a": mk(np.full(4, 2.0)),
                         "b": mk(np.full((2, 2), 2.0))}, root, 3)
    newest = pkg.list_checkpoints(root)[-1][1]
    with open(os.path.join(newest, "a00000.bin"), "r+b") as f:
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(pkg.CheckpointCorrupt, match="checksum"):
        pkg.validate_checkpoint(newest)
    got, man = pkg.load_latest_valid(root, tree)
    out.append((man["step"], np.asarray(got["a"]).tolist()))
    path = pkg.list_checkpoints(root)[0][1]
    data = open(os.path.join(path, "a00001.bin"), "rb").read()
    with open(os.path.join(path, "a00001.bin"), "wb") as f:
        f.write(data[:-8])
    with pytest.raises(pkg.CheckpointCorrupt, match="truncated"):
        pkg.validate_checkpoint(path)
    os.remove(os.path.join(path, "a00001.bin"))
    with pytest.raises(pkg.CheckpointCorrupt, match="missing"):
        pkg.validate_checkpoint(path)
    out.append(pkg.load_latest_valid(root, tree))
    return out


def test_torn_and_corrupt_snapshots_fall_back_as_the_reference(tmp_path):
    want = _fallbacks(jac, lambda a: jnp.asarray(a, jnp.float32),
                      str(tmp_path / "j"))
    got = _fallbacks(ac, lambda a: torch.tensor(a, dtype=torch.float32),
                     str(tmp_path / "t"))
    assert got == want
    assert want[0] == [1] and want[1][0] == 1 and want[2][0] == 1
    assert want[3] is None


def test_keep_last_n_gc(tmp_path):
    for s in range(1, 7):
        ac.save_checkpoint({"w": torch.full((2,), float(s))},
                           str(tmp_path), s, keep=3)
    assert [s for s, _ in ac.list_checkpoints(str(tmp_path))] == [4, 5, 6]
    os.makedirs(tmp_path / ".tmp-00000009-1")
    ac.save_checkpoint({"w": torch.zeros(2)}, str(tmp_path), 7, keep=3)
    assert not [n for n in os.listdir(str(tmp_path))
                if n.startswith(".tmp-")]


def test_same_step_save_discards_redundant_replaces_differing(tmp_path):
    tree = {"w": torch.arange(4.0)}
    ac.save_checkpoint(tree, str(tmp_path), 2, meta={"pos": 2})
    ac.save_checkpoint(tree, str(tmp_path), 2, meta={"pos": 2})
    _, manifest = ac.load_latest_valid(str(tmp_path), tree)
    assert manifest["meta"] == {"pos": 2}
    ac.save_checkpoint(tree, str(tmp_path), 2, meta={"pos": 3})
    _, manifest = ac.load_latest_valid(str(tmp_path), tree)
    assert manifest["meta"] == {"pos": 3}


def test_structural_template_mismatch_is_corrupt(tmp_path):
    ac.save_checkpoint({"a": torch.zeros(2), "b": torch.zeros(2)},
                       str(tmp_path), 1)
    path = ac.list_checkpoints(str(tmp_path))[0][1]
    with pytest.raises(ac.CheckpointCorrupt, match="structure"):
        ac.load_checkpoint(path, {"a": torch.zeros(2), "c": torch.zeros(2)})
    with pytest.raises(ac.CheckpointCorrupt, match="leaves"):
        ac.load_checkpoint(path, {"a": torch.zeros(2)})


def test_core_tensor_leaf_and_distributed_checkpoint_raise_naming_queue(
        tmp_path):
    import paddle_tpu as paddle

    t = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    with pytest.raises(NotImplementedError, match="A11"):
        ac.save_checkpoint({"t": t}, str(tmp_path), 1)
    assert not ac.list_checkpoints(str(tmp_path))
    ac.save_checkpoint({"t": torch.zeros(2, 2)}, str(tmp_path), 1)
    with pytest.raises(NotImplementedError, match="A11"):
        ac.load_latest_valid(str(tmp_path), {"t": paddle.zeros([2, 2])})
    with pytest.raises(NotImplementedError, match="A10"):
        from paddle_tpu_torch.distributed import checkpoint  # noqa: F401
    import paddle_tpu_torch.distributed.resilience as res
    with pytest.raises(NotImplementedError, match="A11"):
        res.ResilientTraining


# ---------------------------------------------------------------------------
# ResumableIterator
# ---------------------------------------------------------------------------
class _Loader:
    """A loader with the reference DataLoader's native position protocol
    (``state_dict``/``load_state_dict`` of ``{"epoch", "batch"}``,
    ``set_epoch``, ``len``): what the port's ``io`` will provide (A11)."""

    def __init__(self, n):
        self.n, self.epoch, self.start = n, 0, 0
        self.loads = []

    def __len__(self):
        return self.n

    def set_epoch(self, e):
        self.epoch = e

    def state_dict(self):
        return {"epoch": self.epoch, "batch": self.start}

    def load_state_dict(self, sd):
        self.loads.append(dict(sd))
        self.epoch, self.start = sd["epoch"], sd["batch"]

    def __iter__(self):
        start, self.start = self.start, 0
        return iter([(self.epoch, i) for i in range(start, self.n)])


def _positions(cls, make, n, load=None):
    it = cls(make())
    if load is not None:
        it.load_state_dict(load)
    out = []
    for _ in range(n):
        b = next(it)
        out.append((b, it.state_dict()))
    return out


@pytest.mark.parametrize("source,load", [
    ("factory", None), ("factory", {"epoch": 1, "index": 2}),
    ("factory", {"epoch": 0, "index": 5}), ("list", None),
    ("list", {"epoch": 2, "index": 4}), ("loader", None),
    ("loader", {"epoch": 0, "index": 3}),
    ("loader", {"epoch": 1, "index": 5})])
def test_resumable_iterator_state_dicts_equal_reference(source, load):
    data = list(range(5))
    makes = {"factory": lambda: (lambda e: iter(data)),
             "list": lambda: data,
             "loader": lambda: _Loader(5)}
    want = _positions(JIter, makes[source], 13, load)
    got = _positions(ResumableIterator, makes[source], 13, load)
    assert got == want


def test_resumable_iterator_epoch_rollover_and_resume():
    data = list(range(5))
    it = ResumableIterator(lambda e: iter(data))
    assert [next(it) for _ in range(7)] == [0, 1, 2, 3, 4, 0, 1]
    assert it.state_dict() == {"epoch": 1, "index": 2}
    it2 = ResumableIterator(lambda e: iter(data))
    it2.load_state_dict({"epoch": 1, "index": 2})
    assert [next(it2) for _ in range(4)] == [2, 3, 4, 0]


def test_native_skip_and_resume_exactly_at_epoch_end():
    loader = _Loader(3)
    it = ResumableIterator(loader)
    it.load_state_dict({"epoch": 0, "index": 3})         # == epoch length
    assert next(it) == (1, 0)                            # next epoch
    assert it.state_dict() == {"epoch": 1, "index": 1}
    assert loader.loads == [{"epoch": 0, "batch": 3}]


@pytest.mark.parametrize("cls", [JIter, ResumableIterator])
def test_resume_past_shrunk_source_raises(cls):
    it = cls(lambda e: iter(range(3)))
    it.load_state_dict({"epoch": 1, "index": 5})
    with pytest.raises(RuntimeError, match="fast-forward"):
        next(it)
    it = cls(_Loader(3))
    it.load_state_dict({"epoch": 0, "index": 5})
    with pytest.raises(RuntimeError, match="fast-forward"):
        next(it)
    with pytest.raises(RuntimeError, match="empty epoch"):
        next(cls(lambda e: iter([])))


@pytest.mark.parametrize("workers,inflight", [(1, 4 << 30), (4, 1),
                                              (8, 4 << 30)])
def test_threaded_writer_and_reader_equal_the_serial_ones(
        workers, inflight, tmp_path, monkeypatch):
    """Any number of writer threads and any in-flight cap write the same
    snapshot byte for byte, and a torn write leaves no temp dir."""
    jt, tt = _llama_trees("adafactor", jnp.bfloat16)
    monkeypatch.setattr(ac, "WORKERS", 1)
    ac.save_checkpoint(tt, str(tmp_path / "serial"), 1, meta={"a": 1})
    monkeypatch.setattr(ac, "WORKERS", workers)
    monkeypatch.setattr(ac, "_INFLIGHT_BYTES", inflight)
    ac.save_checkpoint(tt, str(tmp_path / "threads"), 1, meta={"a": 1})
    assert _snapshot(str(tmp_path / "serial"))[1] \
        == _snapshot(str(tmp_path / "threads"))[1]
    got, _ = ac.load_latest_valid(str(tmp_path / "threads"), tt)
    for a, b in zip(ac.flatten(got)[0], ac.flatten(tt)[0]):
        assert torch.equal(a, b)

    def die(i):
        if i >= 5:
            raise OSError("disk on fire")
    with pytest.raises(OSError):
        ac.save_checkpoint(tt, str(tmp_path / "threads"), 2, fail_hook=die)
    assert sorted(os.listdir(tmp_path / "threads")) == ["step-00000001"]


def test_ckpt_io_tool_times_a_tiny_state_on_the_cpu(tmp_path, capsys):
    from paddle_tpu_torch.tools import ckpt_io

    assert ckpt_io.main(["--device", "cpu", "--size", "tiny", "--dir",
                         str(tmp_path)]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["workers"] for r in doc["runs"]] \
        == [ac.WORKERS, 1, 1, ac.WORKERS]
    assert doc["tree_bytes"] > 0 and doc["parts_serial"]["leaves"] > 0
    assert not os.listdir(tmp_path)
