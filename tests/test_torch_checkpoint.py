"""The port's checkpoint store and checkpoints across the two packages, on
the CPU.

- Every behaviour ``tests/test_checkpoint.py`` holds the reference's store
  to, on the port's store: the round trip, atomic checksummed writes,
  every corruption mode as a typed ``CheckpointCorruptError``, the
  newest-valid fallback, retention and ``.tmp`` clean-up; and tensor
  leaves, which the port's store takes.
- A checkpoint written by the JAX ``CompactTrainer`` resumes in the
  port's: the next 3 steps match the JAX trainer's own continued run
  within ``TRAIN_TOL``.
- A checkpoint written by the port's trainer loads in the JAX package,
  with the spec (a list stays a list) and every leaf (values and types)
  equal to the JAX trainer's own checkpoint of the same state, and the
  JAX ``CompactTrainer.restore`` continues from it.
"""
import json
import os
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.config import GNNConfig as JaxConfig
from repro.core.strategies import strategy_views as jax_views
from repro.core.trainer import CompactTrainer as JaxTrainer
from repro.graph import sbm_graph as jax_sbm
from repro.models import make_gnn as jax_make_gnn
from repro.optim import adam as jax_adam
from repro_torch.checkpoint import (CheckpointCorruptError, checkpoint_steps,
                                    latest_step, load_checkpoint,
                                    save_checkpoint, verify_checkpoint)
from repro_torch.config import GNNConfig
from repro_torch.core.strategies import strategy_views
from repro_torch.core.trainer import CompactTrainer
from repro_torch.graph.datasets import sbm_graph
from repro_torch.models import make_gnn
from repro_torch.optim import adam
from repro_torch.weights import params_from_jax

TRAIN_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tree(step):
    return {"params": {"w": np.arange(6, dtype=np.float32) + step,
                       "b": np.zeros(3, np.float32)},
            "step": np.asarray(step, np.int64)}


def _path(d, step):
    return os.path.join(str(d), f"step_{step:08d}.npz")


def _rewrite(p, edit):
    """Rewrite a checkpoint's leaves through ``edit`` under its original
    manifest."""
    with np.load(p) as data:
        flat = {k: data[k] for k in data.files if k != "__manifest__"}
        manifest = bytes(data["__manifest__"])
    edit(flat)
    with open(p, "wb") as f:
        np.savez(f, __manifest__=np.frombuffer(manifest, dtype=np.uint8),
                 **flat)


# -- the store -------------------------------------------------------------------


def _roundtrip(d):
    tree = {"a": np.arange(4.0), "b": (np.ones(2), [np.zeros(1)]),
            "c": np.asarray(7)}
    save_checkpoint(d, 1, tree)
    got = load_checkpoint(d, 1)
    assert isinstance(got["b"], tuple) and isinstance(got["b"][1], list)
    assert np.array_equal(got["a"], tree["a"])
    assert np.array_equal(got["b"][0], tree["b"][0])
    assert int(got["c"]) == 7


def _tensor_leaves(d):
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    save_checkpoint(d, 1, {"t": t, "n": 5, "l": [t[0]]})
    got = load_checkpoint(d, 1)
    assert got["t"].dtype == np.float32 and np.array_equal(got["t"],
                                                          t.numpy())
    assert got["n"].dtype == np.int64 and int(got["n"]) == 5
    assert isinstance(got["l"], list)


def _atomic_no_tmp(d):
    p = save_checkpoint(d, 3, _tree(3))
    assert os.path.exists(p)
    assert [f for f in os.listdir(d) if f.endswith(".tmp")] == []
    assert verify_checkpoint(p)


def _truncated(d):
    p = save_checkpoint(d, 1, _tree(1))
    data = open(p, "rb").read()
    open(p, "wb").write(data[: len(data) // 2])
    with pytest.raises(CheckpointCorruptError, match="unreadable"):
        load_checkpoint(d, 1)
    assert not verify_checkpoint(p)


def _not_a_zip(d):
    open(_path(d, 2), "wb").write(b"this is not an npz at all")
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(d, 2)


def _missing_manifest(d):
    np.savez(open(_path(d, 1), "wb"), w=np.ones(3))
    with pytest.raises(CheckpointCorruptError, match="__manifest__"):
        load_checkpoint(d, 1)


def _flipped_leaf(d):
    p = save_checkpoint(d, 1, _tree(1))

    def flip(flat):
        key = sorted(k for k in flat if k != "step")[0]
        flat[key] = flat[key] + 1.0

    _rewrite(p, flip)
    with pytest.raises(CheckpointCorruptError, match="checksum mismatch"):
        load_checkpoint(d, 1)


def _missing_leaf(d):
    p = save_checkpoint(d, 1, _tree(1))
    _rewrite(p, lambda flat: flat.pop(sorted(flat)[0]))
    with pytest.raises(CheckpointCorruptError, match="missing"):
        load_checkpoint(d, 1)


def _bare_spec_manifest(d):
    spec = {"__kind__": "dict", "items": {"w": {"__kind__": "leaf"}}}
    with open(_path(d, 9), "wb") as f:
        np.savez(f, __manifest__=np.frombuffer(
            json.dumps(spec).encode(), dtype=np.uint8), w=np.arange(3.0))
    assert np.array_equal(load_checkpoint(d, 9)["w"], np.arange(3.0))


def _falls_back(d):
    for s in (1, 2, 3):
        save_checkpoint(d, s, _tree(s))
    open(_path(d, 3), "wb").write(b"garbage")
    assert int(load_checkpoint(d)["step"]) == 2
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(d, 3)


def _latest_skips_corrupt(d):
    for s in (1, 2):
        save_checkpoint(d, s, _tree(s))
    open(_path(d, 2), "wb").write(b"junk")
    assert latest_step(d) == 1
    assert latest_step(d, validate=False) == 2
    open(_path(d, 1), "wb").write(b"junk")
    assert latest_step(d) is None


def _all_corrupt(d):
    save_checkpoint(d, 1, _tree(1))
    open(_path(d, 1), "wb").write(b"junk")
    with pytest.raises(CheckpointCorruptError, match="all corrupt"):
        load_checkpoint(d)


def _empty_dir(d):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(d)
    assert latest_step(d) is None and checkpoint_steps(d) == []


def _stale_tmp(d):
    stale = os.path.join(d, "step_00000007.npz.tmp")
    open(stale, "wb").write(b"half-written crash debris")
    save_checkpoint(d, 8, _tree(8))
    assert not os.path.exists(stale)
    assert checkpoint_steps(d) == [8]


def _retention(d):
    for s in range(1, 6):
        save_checkpoint(d, s, _tree(s), keep=3)
    assert checkpoint_steps(d) == [3, 4, 5]
    assert int(load_checkpoint(d)["step"]) == 5


def _keep_zero(d):
    for s in range(1, 4):
        save_checkpoint(d, s, _tree(s), keep=0)
    assert checkpoint_steps(d) == [1, 2, 3]


def _leaf_crc(d):
    p = save_checkpoint(d, 1, _tree(1))
    with np.load(p) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        for k, want in manifest["checksums"].items():
            got = zlib.crc32(
                np.ascontiguousarray(data[k]).tobytes()) & 0xFFFFFFFF
            assert got == int(want)


@pytest.mark.parametrize("check", [
    _roundtrip, _tensor_leaves, _atomic_no_tmp, _truncated, _not_a_zip,
    _missing_manifest, _flipped_leaf, _missing_leaf, _bare_spec_manifest,
    _falls_back, _latest_skips_corrupt, _all_corrupt, _empty_dir,
    _stale_tmp, _retention, _keep_zero, _leaf_crc],
    ids=lambda f: f.__name__.lstrip("_"))
def test_store(check, tmp_path):
    check(str(tmp_path))


# -- trainers ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    kw = dict(num_nodes=160, num_classes=4, feature_dim=8, p_in=0.05,
              p_out=0.005, seed=0)
    return jax_sbm(**kw).add_self_loops(), sbm_graph(**kw).add_self_loops()


CFG = dict(model="gcn", num_layers=2, hidden_dim=16, num_classes=4,
           feature_dim=8)


def _jax_trainer(jg):
    model = jax_make_gnn(JaxConfig(**CFG))
    params = model.init(jax.random.PRNGKey(0), 8)
    return JaxTrainer(model, jg, jax_adam(1e-2), params=params), params


def _port_trainer(pg, params=None):
    model = make_gnn(GNNConfig(**CFG), seed=1)
    return CompactTrainer(model, pg, adam(1e-2), params=params, device="cpu")


def _jv(jg):
    return jax_views(jg, "mini", K=2, seed=0, batch_nodes=24, compact=True)


def _pv(pg):
    return strategy_views(pg, "mini", K=2, seed=0, batch_nodes=24,
                          compact=True)


def _manifest(path):
    with np.load(path) as data:
        return json.loads(bytes(data["__manifest__"]).decode())


def test_a_jax_checkpoint_resumes_in_the_port(graphs, tmp_path):
    jg, pg = graphs
    jt, _ = _jax_trainer(jg)
    js = _jv(jg)
    jt.fit(js, steps=4, prefetch=False, checkpoint_dir=str(tmp_path),
           checkpoint_every=4)
    want = jt.fit(js, steps=3, prefetch=False)["losses"]
    pt = _port_trainer(pg)      # other initial params: restore must win
    assert pt.restore(str(tmp_path)) == 4
    assert pt.opt_state["step"] == 4 and pt.view_cursor == 4
    stream = _pv(pg)
    got = pt.fit(stream, steps=3, prefetch=False)["losses"]
    assert stream.cursor == 7
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL, atol=TRAIN_TOL)
    final = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params))
    for k, p in pt.params.items():
        np.testing.assert_allclose(p.detach().numpy(), final[k].numpy(),
                                   rtol=TRAIN_TOL, atol=TRAIN_TOL)


def test_a_port_checkpoint_loads_in_the_jax_package(graphs, tmp_path):
    jg, pg = graphs
    jt, params = _jax_trainer(jg)
    init = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    pt, ps = _port_trainer(pg, params=init), _pv(pg)
    pt.fit(ps, steps=4, prefetch=False)
    mine = pt.save(str(tmp_path / "port"))
    # the JAX trainer's own checkpoint of the same state
    jt.fit(_jv(jg), steps=4, prefetch=False)
    theirs = jt.save(str(tmp_path / "jax"))
    assert _manifest(mine)["spec"] == _manifest(theirs)["spec"]
    got, ref = jax_load(str(tmp_path / "port")), jax_load(
        str(tmp_path / "jax"))
    assert isinstance(got["params"]["layers"], list)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_got, flat_ref):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=TRAIN_TOL, atol=TRAIN_TOL,
                                   err_msg=str(path))
    # every leaf is, bit for bit, the port's own state
    for tree, live in ((got["params"], pt.params),
                       (got["opt_state"]["m"], pt.opt_state["m"]),
                       (got["opt_state"]["v"], pt.opt_state["v"])):
        loaded = params_from_jax(tree)
        assert loaded.keys() == live.keys()
        for k, t in live.items():
            assert torch.equal(loaded[k], t.detach()), k
    assert int(got["opt_state"]["step"]) == 4 and int(got["step"]) == 4
    assert int(got["view_cursor"]) == 4
    # and the JAX trainer continues from it as from its own
    jt2, _ = _jax_trainer(jg)
    assert jt2.restore(str(tmp_path / "port")) == 4
    cont = jt2.fit(_jv(jg), steps=3, prefetch=False)["losses"]
    want = pt.fit(ps, steps=3, prefetch=False)["losses"]
    np.testing.assert_allclose(cont, want, rtol=TRAIN_TOL, atol=TRAIN_TOL)


def test_restore_falls_back_past_a_truncated_newest(graphs, tmp_path):
    _, pg = graphs
    tr = _port_trainer(pg)
    tr.fit(_pv(pg), steps=4, checkpoint_dir=str(tmp_path),
           checkpoint_every=2)
    assert checkpoint_steps(str(tmp_path)) == [2, 4]
    p4 = _path(tmp_path, 4)
    open(p4, "wb").write(open(p4, "rb").read()[:100])
    tr2 = _port_trainer(pg)
    assert tr2.restore(str(tmp_path)) == 2 and tr2.step_num == 2
