"""The port over several processes, one rank each (``repro_torch.launch.
ranks``), on the CPU over gloo, against the same work in one process
(``LocalComm``) and against the JAX package.

- ``ProcessGroupComm`` at two ranks holding two partitions each (P=4):
  the exchange, its backward, both reductions and the gather bitwise
  ``LocalComm(4)``'s; a P the group does not divide is refused.
- The engine ``Trainer`` through ``api.make_trainer(TrainJob(
  engine_partitions=4, ranks=R))`` at R = 2 and 4, GAT-E and GCN (two
  layers, hidden 16), on the JAX engine's weights: step 1's loss and
  gradients within 1e-6 of ``LocalComm``'s and within 1e-5 of the JAX
  engine's ``make_loss_and_grad`` on four host devices (a subprocess);
  ten Adam steps, every rank's losses bitwise equal and within 1e-4 of
  ``LocalComm``'s; the same capture count on every rank; a checkpoint
  that rank 0 writes and every rank resumes, bitwise the unbroken fit.
- The CLI and the distributed example over ranks; the refusals (P % R,
  too few cards) and ``resolve_device`` inside a rank.
- Expert parallelism with one model rank per process (reduced Mixtral,
  float32, ``make_host_mesh``) at 2 and 4 processes: the prefill's
  logits bitwise the ``LocalComm`` mesh's, the loss and its gradients
  within 1e-6 of each one's scale, the dropped pairs equal; the
  reference's ``build_model(cfg, moe_impl="ep", mesh)`` within that
  file's tolerances; each process's expert stacks bitwise the matching
  slice of a whole model's; the ``ValueError``s where the reference
  refuses.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.arch import build_model
from repro_torch.launch.mesh import ExpertMesh
from repro_torch.launch.ranks import launch
from repro_torch.weights import lm_params_from_jax, params_from_jax

import torch_ranks_workers as workers

ROOT = Path(__file__).resolve().parents[1]
GLOO_TOL = 1e-6     # ProcessGroupComm vs LocalComm
STEP1_TOL = 1e-5    # the engine vs the JAX engine, step 1
TRAIN_TOL = 1e-4    # over a trajectory
TOL = 1e-4          # EP vs the reference, * max(|y|, 1)
WORLDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


_ORACLE = r"""
import pickle, re
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.arch import build_model
from repro.config import GNNConfig, get_arch_config
from repro.core.engine import HybridParallelEngine
from repro.core.partition import build_partitions
from repro.core.strategies import global_batch_view, shard_view
from repro.graph import make_dataset
from repro.models import make_gnn


def flat(tree):
    def name(path):
        key = jax.tree_util.keystr(path)
        return ".".join(re.findall(r"\['?([^'\]]+)'?\]", key))
    return {name(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


out = {"gnn": {}, "lm": {}}
for model, (dataset, n) in GNN_CASES.items():
    g = make_dataset(dataset, num_nodes=n, seed=0)
    if model == "gcn":
        g = g.add_self_loops()
    ed = g.edge_features.shape[1] if g.edge_features is not None else 0
    cfg = GNNConfig(model=model, num_layers=2, hidden_dim=16,
                    num_classes=int(g.labels.max()) + 1,
                    feature_dim=g.node_features.shape[1],
                    edge_feature_dim=ed,
                    num_heads=4 if model == "gat_e" else 1)
    m = make_gnn(cfg)
    params = m.init(jax.random.PRNGKey(0), cfg.feature_dim)
    sg = build_partitions(g, 4, gcn_norm=model == "gcn")
    eng = HybridParallelEngine(m, sg)
    staged = eng.stage_view(shard_view(sg.plan, global_batch_view(g, 2)))
    loss, grads = eng.make_loss_and_grad()(params, eng._device_data, staged)
    out["gnn"][model] = {"params": flat(params), "loss": float(loss),
                         "grads": flat(grads)}

cfg = get_arch_config("mixtral-8x7b").reduced().replace(dtype="float32")
B, S = LM_BATCH
rng = np.random.default_rng(1)
batch = {k: rng.integers(0, 1024, (B, S)) for k in ("tokens", "labels")}
jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
for M in WORLDS:
    mesh = Mesh(np.array(jax.devices()[:M]).reshape(1, M), ("data", "model"))
    jm = build_model(cfg, moe_impl="ep", mesh=mesh, remat=False)
    params = jm.init(jax.random.PRNGKey(LM_SEED))
    logits, _, _ = jm.prefill(params, {"tokens": jb["tokens"]}, cache_len=S)
    loss, grads = jax.value_and_grad(lambda p: jm.loss(p, jb))(params)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    out["lm"][M] = {"params": tree(params), "logits": np.asarray(logits),
                    "loss": float(loss), "grads": tree(grads)}
with open(OUT, "wb") as f:
    pickle.dump(out, f)
print("ALL_OK")
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The JAX engine's step 1 at P=4 and the reference's EP Mixtral at
    (1, 2) and (1, 4), from one subprocess with four host devices."""
    path = tmp_path_factory.mktemp("jax_ranks") / "out.pkl"
    head = (f"OUT = {str(path)!r}\nGNN_CASES = {workers.GNN_CASES!r}\n"
            f"LM_BATCH = {workers.LM_BATCH!r}\nLM_SEED = "
            f"{workers.LM_SEED!r}\nWORLDS = {WORLDS!r}\n")
    assert "ALL_OK" in run_with_devices(head + _ORACLE, n_devices=4,
                                        timeout=600)
    with open(path, "rb") as f:
        return pickle.load(f)


def _gnn_params(oracle) -> dict:
    return {m: oracle["gnn"][m]["params"] for m in workers.GNN_CASES}


# -- the engine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def local_engine(oracle, tmp_path_factory):
    """Every model's run with all four partitions in this process."""
    root = tmp_path_factory.mktemp("local_ck")
    return {m: workers.gnn_run(m, 1, p, str(root / m))
            for m, p in _gnn_params(oracle).items()}


@pytest.fixture(scope="module", params=WORLDS)
def engine_ranks(request, oracle, tmp_path_factory):
    """Every rank's results at ``request.param`` processes."""
    world = request.param
    root = tmp_path_factory.mktemp(f"ranks{world}_ck")
    return world, launch(workers.engine_rank, world,
                         args=(world, _gnn_params(oracle), str(root)),
                         device="cpu")


def test_process_group_comm_holds_two_partitions_a_rank(engine_ranks):
    world, ranks = engine_ranks
    for r, got in enumerate(ranks):
        checks = got["comm"]
        assert checks["layout"] == (4, 4 // world, r * (4 // world))
        for name in ("all_to_all", "backward", "all_reduce",
                     "all_reduce_grads", "all_gather"):
            assert checks[name] is True, (world, r, name)
        assert "do not split evenly" in checks["refused"]


def _close(got: dict, want: dict, tol: float, what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("model", list(workers.GNN_CASES))
def test_engine_step1_matches_local_comm(engine_ranks, local_engine, model):
    world, ranks = engine_ranks
    want = local_engine[model]
    for r, got in enumerate(ranks):
        got = got[model]
        assert abs(float(got["loss"]) - float(want["loss"])) < GLOO_TOL
        _close(got["grads"], want["grads"], GLOO_TOL, f"R={world} rank {r}")


@pytest.mark.parametrize("model", list(workers.GNN_CASES))
def test_engine_step1_matches_jax_engine(engine_ranks, oracle, model):
    world, ranks = engine_ranks
    want = oracle["gnn"][model]
    for r, got in enumerate(ranks):
        got = got[model]
        assert abs(float(got["loss"]) - want["loss"]) < STEP1_TOL, r
        _close(got["grads"], want["grads"], STEP1_TOL, f"R={world} rank {r}")


@pytest.mark.parametrize("model", list(workers.GNN_CASES))
def test_engine_fit_is_the_same_on_every_rank(engine_ranks, local_engine,
                                               model):
    """Ten Adam steps: every rank's losses bitwise equal (the group's
    loss), within ``TRAIN_TOL`` of one process's, falling; every rank
    the same capture count (none on the CPU) and its contract held."""
    world, ranks = engine_ranks
    first = ranks[0][model]["losses"]
    assert len(first) == workers.GNN_STEPS and np.isfinite(first).all()
    for got in ranks[1:]:
        np.testing.assert_array_equal(got[model]["losses"], first)
    np.testing.assert_allclose(first, local_engine[model]["losses"],
                               rtol=TRAIN_TOL, atol=TRAIN_TOL)
    assert first[-1] < first[0]
    assert {got[model]["captures"] for got in ranks} == {0}
    assert {got[model]["device"] for got in ranks} == {"cpu"}


@pytest.mark.parametrize("model", list(workers.GNN_CASES))
def test_engine_checkpoint_written_once_resumed_everywhere(engine_ranks,
                                                           model):
    """Rank 0 writes step 5's checkpoint; every rank resumes from it, and
    the resumed fit is the unbroken one, bit for bit."""
    world, ranks = engine_ranks
    for r, got in enumerate(ranks):
        got = got[model]
        assert got["checkpoints"] == ["step_00000005.npz"], (r, got)
        assert got["resumed_step"] == workers.GNN_STEPS
        np.testing.assert_array_equal(got["resumed"], got["losses"])


# -- the CLI and the example --------------------------------------------------


def _run(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _final_loss(stdout: str) -> float:
    line, = [ln for ln in stdout.splitlines()
             if ln.startswith("final train loss: ")]
    return float(line.split(": ")[1])


def test_cli_over_four_ranks_matches_one():
    cmd = ["-m", "repro_torch.launch.train", "gnn", "--dataset", "cora",
           "--engine-partitions", "4", "--steps", "10", "--device", "cpu"]
    four = _run(*cmd, "--ranks", "4")
    assert four.returncode == 0, four.stderr[-3000:]
    assert "[cpu x4 ranks] final test acc:" in four.stdout
    one = _run(*cmd)
    assert one.returncode == 0, one.stderr[-3000:]
    assert abs(_final_loss(four.stdout) - _final_loss(one.stdout)) \
        < TRAIN_TOL


def test_cli_refuses_ranks_that_do_not_divide_the_partitions():
    got = _run("-m", "repro_torch.launch.train", "gnn", "--dataset", "cora",
               "--engine-partitions", "4", "--ranks", "3", "--steps", "2",
               "--device", "cpu")
    assert got.returncode != 0
    assert "4 partitions do not split evenly over 3 ranks" in got.stderr


def test_example_over_two_ranks_prints_the_one_process_lines():
    cmd = ["examples/distributed_training_torch.py", "--device", "cpu",
           "--steps", "6", "--nodes", "600", "--workers", "4",
           "--no-prefetch"]
    two = _run(*cmd, "--ranks", "2")
    one = _run(*cmd)
    assert two.returncode == 0 and one.returncode == 0, two.stderr[-3000:]

    def lines(out):   # the strategy lines without their wall times
        return [ln.split("), ")[-1] for ln in out.splitlines()
                if ln.startswith("[")]
    assert len(lines(one.stdout)) == 3
    assert lines(two.stdout) == lines(one.stdout)
    assert "done: one engine" in two.stdout


def test_cuda_ranks_need_a_card_each(monkeypatch):
    """No fallback: four ranks on a host with one card raise before any
    process starts, and the CLI exits non-zero where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="4 ranks need 4 cards"):
        launch(workers.engine_rank, 4, args=(4, {}, ""), device="cuda")
    monkeypatch.undo()
    got = _run("-m", "repro_torch.launch.train", "gnn", "--dataset", "cora",
               "--engine-partitions", "4", "--ranks", "4", "--steps", "2",
               "--device", "cuda")
    assert got.returncode != 0 and "CUDA" in got.stderr


def test_resolve_device_in_a_rank_is_its_card(monkeypatch):
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device("cuda") == torch.device("cuda")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


# -- expert parallelism, one model rank per process ---------------------------


@pytest.fixture(scope="module", params=WORLDS)
def ep_ranks(request, oracle):
    world = request.param
    params = oracle["lm"][world]["params"]
    return world, launch(workers.ep_rank, world, args=(world, params),
                         device="cpu")


@pytest.fixture(scope="module")
def local_ep(oracle):
    """The LocalComm mesh (1, M) on the same weights, per M."""
    out = {}
    cfg = workers.lm_config()
    for M in WORLDS:
        model = build_model(cfg, moe_impl="ep", mesh=ExpertMesh(1, M))
        model.load_state_dict(lm_params_from_jax(
            cfg, oracle["lm"][M]["params"]), strict=True)
        out[M] = workers.lm_run(model)
    return out


def _blocks(world: int, rank: int, E: int):
    """The experts a process holds, as the test computes them."""
    per = max(E, world) // world
    return slice(rank * per, (rank + 1) * per)


def test_ep_mesh_is_one_model_rank_a_process(ep_ranks):
    world, ranks = ep_ranks
    for got in ranks:
        assert got["mesh"] == (1, world, "ProcessGroupComm", 1)


def test_ep_matches_the_local_comm_mesh(ep_ranks, local_ep):
    """The prefill's logits bitwise; the loss and the gradients (the
    router's summed over the processes in another order) within 1e-6 of
    each one's scale; each process's expert gradients those of its
    experts; the dropped pairs over the processes the same."""
    world, ranks = ep_ranks
    want = local_ep[world]
    E = workers.lm_config().moe.num_experts
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["logits"], want["logits"])
        assert abs(got["loss"] - want["loss"]) < GLOO_TOL * max(
            1.0, abs(want["loss"]))
        for name, g in want["grads"].items():
            if ".ffn.w" in name:
                g = g[_blocks(world, r, E)]
            scale = max(float(np.abs(g).max()), 1.0)
            np.testing.assert_allclose(got["grads"][name], g, rtol=0,
                                       atol=GLOO_TOL * scale,
                                       err_msg=f"rank {r} {name}")
    dropped = np.sum([got["dropped"] for got in ranks], axis=0)
    assert dropped.tolist() == want["dropped"] and dropped[0] > 0


def test_ep_matches_the_reference(ep_ranks, oracle):
    """Within ``test_torch_moe_ep.py``'s tolerances of the reference's
    EP model on a (1, M) mesh: the prefill's logits (rtol 1e-4, atol
    1e-5), the loss and each gradient (1e-4 of its scale)."""
    world, ranks = ep_ranks
    want = oracle["lm"][world]
    cfg = workers.lm_config()
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4,
                                   atol=1e-5)
        assert abs(got["loss"] - want["loss"]) < TOL * max(
            1.0, abs(want["loss"]))
        mesh = ExpertMesh(1, world, _RankComm(world, r))
        for name, g in lm_params_from_jax(cfg, want["grads"],
                                          mesh).items():
            g = g.numpy()
            scale = max(float(np.abs(g).max()), 1.0)
            np.testing.assert_allclose(got["grads"][name], g, rtol=0,
                                       atol=TOL * scale,
                                       err_msg=f"rank {r} {name}")


class _RankComm:
    """Where a process of a ``world``-process group stands (what
    ``local_experts`` reads)."""

    def __init__(self, world: int, rank: int):
        self.P, self.start, self.count = world, rank, 1


def test_ep_stacks_are_slices_of_a_whole_model(ep_ranks):
    """Each process's expert stacks hold its ``E_pad / model`` experts,
    bitwise those of a model that holds every expert, from the same
    seed; ``params_from_jax`` with the mesh cuts them alike."""
    world, ranks = ep_ranks
    cfg = workers.lm_config()
    whole = {n: p.detach().numpy() for n, p in build_model(
        cfg, torch.Generator().manual_seed(workers.LM_SEED)
    ).named_parameters()}
    E = cfg.moe.num_experts
    for r, got in enumerate(ranks):
        assert len(got["stacks"]) == 3 * cfg.num_layers
        for name, stack in got["stacks"].items():
            assert stack.shape[0] == E // world
            np.testing.assert_array_equal(stack,
                                          whole[name][_blocks(world, r, E)])
        mesh = ExpertMesh(1, world, _RankComm(world, r))
        cut = params_from_jax({"ffn": {k: whole["blocks.0.ffn." + k]
                                       for k in ("router", "wi_gate",
                                                 "wi_up", "wo")}}, mesh)
        np.testing.assert_array_equal(cut["ffn.wi_up"].numpy(),
                                      got["stacks"]["blocks.0.ffn.wi_up"])
        np.testing.assert_array_equal(cut["ffn.router"].numpy(),
                                      whole["blocks.0.ffn.router"])


def test_ep_raises_where_the_reference_raises(ep_ranks):
    """A decode step (S = 1) and a prefill whose S does not split over
    the model ranks, and an expert count that does not pad to a multiple
    of them, raise ``ValueError`` on every process, before any
    exchange."""
    world, ranks = ep_ranks
    for got in ranks:
        raised = got["raised"]
        assert "evenly divisible" in raised["decode"]
        assert "evenly divisible" in raised["sequence"]
        assert "multiple of the device count" in raised["experts"]
