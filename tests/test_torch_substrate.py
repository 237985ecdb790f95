"""The port's training substrate against the reference, on the CPU.

Data pipeline, checkpointing, watchdog, ``synthetic_text_tokens`` and the
``utils`` helpers. Every test of ``tests/test_substrate.py``'s data,
checkpoint and watchdog sections has its mirror here. Everything compared
is exact: the loader's batches byte for byte, checkpoint files byte for
byte and restored leaves bitwise, watchdog verdicts, token arrays, the
helpers' strings and sizes.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as ref_utils
from repro.checkpoint import CheckpointManager as RefManager
from repro.checkpoint import restore_tree as ref_restore
from repro.checkpoint import save_tree as ref_save
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import LoaderState as RefLoaderState
from repro.data.pipeline import ShardedLoader as RefLoader
from repro.distributed.watchdog import StepWatchdog as RefWatchdog
from repro.distributed.watchdog import WatchdogConfig as RefWatchdogConfig
from repro.snn.data import synthetic_text_tokens as ref_text_tokens
from repro_torch import utils
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.data.pipeline import DataConfig, LoaderState, Prefetcher, ShardedLoader
from repro_torch.distributed.watchdog import StepWatchdog, WatchdogConfig
from repro_torch.models.model import TensorSpec
from repro_torch.snn.data import synthetic_text_tokens


# ------------------------------------------------------------------- data ---
def test_loader_deterministic_and_resumable():
    cfg = DataConfig(vocab=256, seq_len=32, global_batch=4, seed=1)
    it = iter(ShardedLoader(cfg))
    b0, b1, _ = next(it), next(it), next(it)
    nb1 = next(iter(ShardedLoader(cfg, state=LoaderState(step=1))))
    np.testing.assert_array_equal(b1["tokens"], nb1["tokens"])
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_loader_shards_partition_global_batch():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=8, seed=3)
    whole = next(iter(ShardedLoader(cfg)))
    parts = [next(iter(ShardedLoader(cfg, shard=s, num_shards=4))) for s in range(4)]
    np.testing.assert_array_equal(whole["tokens"], np.concatenate([p["tokens"] for p in parts]))


def test_prefetcher_preserves_order():
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=2, seed=0)
    base = [next(iter(ShardedLoader(cfg, state=LoaderState(step=i)))) for i in range(4)]
    got = list(Prefetcher(iter(base), depth=2))
    assert len(got) == len(base)
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_labels_are_shifted_tokens():
    b = next(iter(ShardedLoader(DataConfig(vocab=64, seq_len=16, global_batch=2, seed=0))))
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("vocab,seq,batch,seed,shard,shards", [
    (256, 32, 4, 0, 0, 1), (50304, 64, 2, 7, 0, 1), (512, 16, 8, 3, 2, 4)])
def test_loader_batches_byte_equal_to_the_reference(vocab, seq, batch, seed, shard, shards):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    ours = ShardedLoader(DataConfig(**kw), shard=shard, num_shards=shards,
                         state=LoaderState(step=2))
    theirs = RefLoader(RefDataConfig(**kw), shard=shard, num_shards=shards,
                       state=RefLoaderState(step=2))
    for a, b in zip((next(iter(ours)) for _ in range(3)), (next(iter(theirs)) for _ in range(3))):
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            assert a[k].tobytes() == b[k].tobytes()
    assert ours.state.as_dict() == theirs.state.as_dict() == {"step": 5}
    assert LoaderState.from_dict({"step": "4"}).step == 4


# ------------------------------------------------------------- checkpoint ---
def test_checkpoint_roundtrip_and_gc():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2, async_save=False)
        tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
        for step in (1, 2, 3, 4):
            mgr.save(step, {"a": tree["a"] * step, "b": {"c": tree["b"]["c"] * step}},
                     {"s": step})
        assert mgr.all_steps() == [3, 4]  # keep-2 GC
        step, got, extra = mgr.restore_latest(tree)
        assert step == 4 and extra["s"] == 4
        assert torch.equal(got["a"], tree["a"] * 4) and got["a"].dtype == tree["a"].dtype


def test_checkpoint_atomicity_partial_dir_ignored():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3, async_save=False)
        mgr.save(5, {"w": torch.ones(3)})
        os.makedirs(os.path.join(d, "step_0000000009.tmp"))   # a crashed save
        os.makedirs(os.path.join(d, "step_0000000008"))       # no manifest
        assert mgr.latest_step() == 5


def test_checkpoint_shape_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        save_tree(os.path.join(d, "c"), {"w": torch.ones((2, 2))})
        with pytest.raises(ValueError):
            restore_tree(os.path.join(d, "c"), {"w": torch.ones((4,))})
        with pytest.raises(KeyError):
            restore_tree(os.path.join(d, "c"), {"v": torch.ones((2, 2))})


def test_async_save_then_wait():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2, async_save=True)
        mgr.save(1, {"w": torch.ones(8)})
        mgr.wait()
        assert mgr.latest_step() == 1


def test_async_save_error_raised_on_wait():
    with tempfile.TemporaryDirectory() as d:
        root = os.path.join(d, "ckpt")
        mgr = CheckpointManager(root, keep=2, async_save=True)
        os.rmdir(root)
        with open(root, "w"):           # the root is now a file: the save fails
            pass
        mgr.save(1, {"w": torch.ones(2)})
        with pytest.raises(OSError):
            mgr.wait()
        mgr.wait()                     # reported once
        os.remove(root)
        os.makedirs(root)
        mgr.save(2, {"w": torch.ones(2)})
        mgr.wait()
        assert mgr.latest_step() == 2


def test_save_copies_to_the_host_before_returning():
    """An async save writes what the tree held when ``save`` was called,
    even if the caller writes its tensors in place right after."""
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_save=True)
        w = torch.zeros(1 << 16)
        mgr.save(1, {"w": w})
        w.fill_(7.0)
        mgr.wait()
        _, got, _ = mgr.restore_latest({"w": w})
        assert float(got["w"].abs().max()) == 0.0


def _mixed_tree(lib):
    """Leaves of every dtype a training state holds: f32 params, a bf16
    param, int8 patterns, int32 usage, the 0-d int32 step, and a factored
    second moment ({"vr", "vc"})."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal((4, 6)).astype(np.float32)
    i8 = rng.integers(-2, 2, (2, 4, 3)).astype(np.int8)
    i32 = rng.integers(0, 1000, (4, 5)).astype(np.int32)
    vr, vc = np.abs(f32).sum(1), np.abs(f32).sum(0)
    if lib == "jax":
        arr, bf16 = jnp.asarray, jnp.asarray(bf, jnp.bfloat16)
    else:
        arr, bf16 = torch.from_numpy, torch.from_numpy(bf).to(torch.bfloat16)
    return {"params": {"decoder": {"w": arr(f32), "phi_w": {"patterns": arr(i8),
                                                             "usage": arr(i32)}},
                       "embed": bf16},
            "opt": {"step": arr(np.array(3, np.int32)),
                    "v": {"decoder": {"w": {"vr": arr(vr), "vc": arr(vc)}}}}}


def _np_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_np_leaves(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return {prefix: tree.to(torch.float32).numpy()}
        return {prefix: tree.numpy()}
    return {prefix: np.asarray(tree, np.float32 if tree.dtype == jnp.bfloat16 else tree.dtype)}


def test_reference_checkpoint_restores_into_the_port():
    with tempfile.TemporaryDirectory() as d:
        ref_save(os.path.join(d, "c"), _mixed_tree("jax"), {"loader": {"step": 3}})
        like = _mixed_tree("torch")
        got, extra = restore_tree(os.path.join(d, "c"), like)
    assert extra == {"loader": {"step": 3}}
    want = _np_leaves(_mixed_tree("jax"))
    gl = _np_leaves(got)
    assert sorted(gl) == sorted(want)
    for key, w in want.items():
        assert gl[key].dtype == w.dtype and gl[key].shape == w.shape, key
        np.testing.assert_array_equal(gl[key], w, err_msg=key)
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32 and got["opt"]["step"].shape == ()
    assert got["params"]["decoder"]["phi_w"]["patterns"].dtype == torch.int8


def test_port_checkpoint_is_the_references_byte_for_byte_and_restores_there():
    """Same tree, both writers: identical manifests and leaf files. The
    reference restores the port's checkpoint wherever it restores its own;
    a bfloat16 leaf it restores from neither (``np.load`` gives ``|V2``,
    which ``jnp.asarray`` refuses)."""
    with tempfile.TemporaryDirectory() as d:
        ours, theirs = os.path.join(d, "ours"), os.path.join(d, "theirs")
        save_tree(ours, _mixed_tree("torch"), {"loader": {"step": 3}})
        ref_save(theirs, _mixed_tree("jax"), {"loader": {"step": 3}})
        with open(os.path.join(ours, "manifest.json")) as f:
            m_ours = json.load(f)
        with open(os.path.join(theirs, "manifest.json")) as f:
            m_theirs = json.load(f)
        assert m_ours == m_theirs
        assert {m["dtype"] for m in m_ours["leaves"]} == {"float32", "bfloat16", "int8",
                                                          "int32"}
        for m in m_ours["leaves"]:
            with open(os.path.join(ours, m["file"]), "rb") as a, \
                    open(os.path.join(theirs, m["file"]), "rb") as b:
                assert a.read() == b.read(), m["key"]
        like = _mixed_tree("jax")
        no_bf16 = {"params": {"decoder": like["params"]["decoder"]}, "opt": like["opt"]}
        got, extra = ref_restore(ours, no_bf16)
        assert extra == {"loader": {"step": 3}}
        want = _np_leaves(no_bf16)
        for key, arr in _np_leaves(got).items():
            assert arr.dtype == want[key].dtype and arr.shape == want[key].shape, key
            np.testing.assert_array_equal(arr, want[key], err_msg=key)
        for path in (ours, theirs):
            with pytest.raises(TypeError, match="V2"):
                ref_restore(path, like)


def test_missing_usage_leaves_are_zero_filled():
    with tempfile.TemporaryDirectory() as d:
        ref_save(os.path.join(d, "old"), {"w": jnp.ones((2, 3)),
                                          "phi_w": {"patterns": jnp.ones((1, 2, 3), jnp.int8)}})
        like = {"w": torch.zeros((2, 3)),
                "phi_w": {"patterns": torch.zeros((1, 2, 3), dtype=torch.int8),
                          "usage": torch.full((1, 3), 5, dtype=torch.int32)}}
        got, _ = restore_tree(os.path.join(d, "old"), like, missing_ok=("usage",))
        assert torch.equal(got["phi_w"]["usage"], torch.zeros((1, 3), dtype=torch.int32))
        assert torch.equal(got["w"], torch.ones((2, 3)))
        with pytest.raises(KeyError, match="usage"):
            restore_tree(os.path.join(d, "old"), like)


def test_restore_takes_the_like_leafs_dtype_or_a_spec_and_device():
    with tempfile.TemporaryDirectory() as d:
        save_tree(os.path.join(d, "c"), {"a": torch.arange(4, dtype=torch.int32),
                                         "b": torch.ones(2, dtype=torch.bfloat16)})
        got, _ = restore_tree(os.path.join(d, "c"),
                              {"a": TensorSpec((4,), torch.int64),
                               "b": TensorSpec((2,), torch.float32)}, device="cpu")
    assert got["a"].dtype == torch.int64 and got["a"].tolist() == [0, 1, 2, 3]
    assert got["b"].dtype == torch.float32 and got["b"].tolist() == [1.0, 1.0]


def test_latest_extra_and_empty_manager():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_save=False)
        assert mgr.latest_extra() == {} and mgr.restore_latest({"w": torch.ones(1)}) == \
            (None, None, {})
        mgr.save(2, {"w": torch.ones(1)}, {"phi_impl": "coo"})
        assert mgr.latest_extra() == RefManager(d).latest_extra() == {"phi_impl": "coo"}


# --------------------------------------------------------------- watchdog ---
def test_watchdog_escalates_on_persistent_straggler():
    wd = StepWatchdog(WatchdogConfig(window=20, slow_factor=2.0, escalate_after=3, warmup=5))
    assert {wd.record(0.1) for _ in range(30)} == {"ok"}
    v = [wd.record(0.5) for _ in range(3)]
    assert v[-1] == "escalate"
    assert wd.record(0.1) == "ok"


def test_watchdog_verdicts_equal_the_references():
    rng = np.random.default_rng(4)
    times = np.where(rng.random(400) < 0.15, 0.5, 0.1) * rng.uniform(0.8, 1.2, 400)
    kw = dict(window=16, slow_factor=2.0, escalate_after=2, warmup=4)
    ours, theirs = StepWatchdog(WatchdogConfig(**kw)), RefWatchdog(RefWatchdogConfig(**kw))
    got = [ours.record(float(t)) for t in times]
    assert got == [theirs.record(float(t)) for t in times]
    assert "escalate" in got and ours.escalations == theirs.escalations
    assert ours.median == theirs.median
    assert StepWatchdog().median == 0.0


# ------------------------------------------------------ text data, utils ---
@pytest.mark.parametrize("n,classes,seq,vocab,seed", [(16, 2, 32, 256, 0), (9, 5, 7, 50, 3)])
def test_synthetic_text_tokens_equal_the_references(n, classes, seq, vocab, seed):
    x, y = synthetic_text_tokens(n, classes, seq, vocab, seed)
    rx, ry = ref_text_tokens(n, classes, seq, vocab, seed)
    assert x.dtype == rx.dtype == np.int32 and y.dtype == ry.dtype == np.int32
    assert x.tobytes() == rx.tobytes() and y.tobytes() == ry.tobytes()


def test_utils_helpers_equal_the_references():
    for n in (0, 3, 1023, 1024, 5.5e6, 3e12, 2e18):
        assert utils.human_bytes(n) == ref_utils.human_bytes(n)
        assert utils.human_count(n) == ref_utils.human_count(n)
    rng = np.random.default_rng(1)
    arrays = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.integers(0, 5, (7,)).astype(np.int8), "d": np.zeros((), np.int32)}}
    ours = {"a": torch.from_numpy(arrays["a"]).to(torch.bfloat16),
            "b": {"c": torch.from_numpy(arrays["b"]["c"]), "d": torch.zeros((), dtype=torch.int32)},
            "spec": TensorSpec((5, 2), torch.float32), "none": None}
    theirs = {"a": jnp.asarray(arrays["a"], jnp.bfloat16),
              "b": {"c": jnp.asarray(arrays["b"]["c"]), "d": jnp.zeros((), jnp.int32)},
              "spec": jax.ShapeDtypeStruct((5, 2), jnp.float32), "none": None}
    assert utils.tree_bytes(ours) == ref_utils.tree_bytes(theirs) == 24 + 7 + 4 + 40
    assert utils.tree_params(ours) == ref_utils.tree_params(theirs) == 12 + 7 + 1 + 10
    obj = {"x": (np.int64(3), np.float32(0.5)), "t": torch.arange(3), "n": np.ones((2,)),
           "cfg": RefDataConfig(vocab=3, seq_len=2, global_batch=1)}
    ref_obj = dict(obj, t=jnp.arange(3))
    assert utils.asdict_json(obj) == ref_utils.asdict_json(ref_obj)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sub", "o.json")
        utils.dump_json(path, obj)
        ref_utils.dump_json(os.path.join(d, "r.json"), ref_obj)
        assert not os.path.exists(path + ".tmp")
        with open(path) as a, open(os.path.join(d, "r.json")) as b:
            assert a.read() == b.read()
        assert utils.load_json(path) == ref_utils.load_json(path)


def test_step_timer_history_and_median():
    t = utils.StepTimer()
    assert t.median == 0.0
    for s in (0.0, 0.002, 0.001):
        with t:
            time.sleep(s)
    assert len(t.history) == 3 and t.history[1] >= 0.002
    assert t.median == float(np.median(t.history))
