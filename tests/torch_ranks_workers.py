"""Rank functions for ``test_torch_ranks.py``: each runs in one process of
a gloo group that :func:`repro_torch.launch.ranks.launch` starts, and
imports only the port. Kept apart from the test module so that a spawned
process does not import JAX; it holds no test."""
import os

import numpy as np
import torch

GNN_STEPS = 10
RESUME_AT = 5
# (model, graph): GAT-E on a 400-node alipay_like graph, GCN on a
# 300-node reddit_like graph with self-loops
GNN_CASES = {"gat_e": ("alipay_like", 400), "gcn": ("reddit_like", 300)}
LM_BATCH = (2, 32)              # B, S of the reduced Mixtral's batches
LM_SEED = 3


def gnn_graph(model: str):
    from repro_torch.graph import make_dataset
    name, n = GNN_CASES[model]
    g = make_dataset(name, seed=0, num_nodes=n)
    return g.add_self_loops() if model == "gcn" else g


def gnn_job(model: str, ranks: int):
    """The facade's engine job at P=4: two layers, hidden 16, global
    views, on the CPU."""
    import repro_torch.api as api
    return api.TrainJob(dataset=gnn_graph(model), model=model, hidden=16,
                        num_layers=2, engine_partitions=4, ranks=ranks,
                        steps=GNN_STEPS, eval_every=0, device="cpu")


def _trainer(model: str, ranks: int, params: dict):
    """``api.make_trainer`` for the job, its weights ``params`` (a
    ``state_dict`` of numpy arrays)."""
    import repro_torch.api as api
    trainer, views, *_ = api.make_trainer(gnn_job(model, ranks))
    trainer.model.load_state_dict({k: torch.from_numpy(v.copy())
                                   for k, v in params.items()})
    return trainer, views


def gnn_run(model: str, ranks: int, params: dict, ck_dir: str) -> dict:
    """Step 1's loss and gradients over the global view, ten Adam steps
    through ``fit``, then the same ten as five, a checkpoint, and five
    more resumed by a fresh trainer. Numpy arrays and counts."""
    from repro_torch.core.strategies import global_batch_view, shard_view
    trainer, views = _trainer(model, ranks, params)
    eng = trainer.engine
    loss, grads = eng.make_loss_and_grad()(eng.stage_view(
        shard_view(eng.plan, global_batch_view(gnn_graph(model), 2))))
    out = {"loss": loss.numpy().copy(),
           "grads": {k: v.numpy().copy() for k, v in grads.items()}}
    out["losses"] = np.asarray(trainer.fit(views, steps=GNN_STEPS)["losses"])
    trainer.assert_compiled_once()
    out["captures"] = trainer.trace_counts["train_step"]
    out["device"] = str(trainer.device)
    first, views = _trainer(model, ranks, params)
    part = first.fit(views, steps=RESUME_AT, checkpoint_dir=ck_dir,
                     checkpoint_every=RESUME_AT)["losses"]
    out["checkpoints"] = sorted(os.listdir(ck_dir))
    second, views = _trainer(model, ranks, params)
    rest = second.fit(views, steps=GNN_STEPS - RESUME_AT,
                      checkpoint_dir=ck_dir, resume=True)["losses"]
    out["resumed"] = np.asarray(part + rest)
    out["resumed_step"] = second.step_num
    return out


def comm_checks(P: int) -> dict:
    """``ProcessGroupComm`` over this group against ``LocalComm(P)`` in
    this process, on the same seeded rows: the exchange, its backward,
    both reductions and the gather, each bitwise; and the refusal of a
    ``P`` the group does not divide."""
    from repro_torch.core.comm import LocalComm, ProcessGroupComm
    pg, local = ProcessGroupComm(P=P), LocalComm(P)
    mine = slice(pg.start, pg.start + pg.count)
    gen = torch.Generator().manual_seed(0)
    buf = torch.randn((P, P, 3, 5), generator=gen)
    cot = torch.randn((P, P, 3, 5), generator=gen)
    x = torch.randn((P, 7), generator=gen)
    whole = buf.clone().requires_grad_(True)
    (local.all_to_all(whole) * cot).sum().backward()
    part = buf[mine].clone().requires_grad_(True)
    got = pg.all_to_all(part)
    (got * cot[mine]).sum().backward()
    # each process's gradient: its partitions' rows summed; the group's
    # is every process's, summed in rank order
    per_rank = [x[r * pg.count:(r + 1) * pg.count].sum(0)
                for r in range(pg.world)]
    want = per_rank[0]
    for g in per_rank[1:]:
        want = want + g
    grads = {"a": per_rank[pg.rank].clone(),
             "b": per_rank[pg.rank][:3].clone()}
    pg.all_reduce_grads(grads)
    checks = {
        "all_to_all": torch.equal(got, local.all_to_all(buf)[mine]),
        "backward": torch.equal(part.grad, whole.grad[mine]),
        "all_reduce": torch.equal(pg.all_reduce(x[mine]),
                                  local.all_reduce(x)),
        "all_reduce_grads": torch.equal(grads["a"], want)
        and torch.equal(grads["b"], want[:3]),
        "all_gather": torch.equal(pg.all_gather(x[mine]), x),
        "layout": (pg.P, pg.count, pg.start)}
    try:
        ProcessGroupComm(P=pg.world + 1)
        checks["refused"] = ""
    except ValueError as e:
        checks["refused"] = str(e)
    return checks


def engine_rank(rank: int, world: int, params: dict, ck_root: str) -> dict:
    """One rank of the engine's group: :func:`comm_checks` at P=4, then
    :func:`gnn_run` for each model."""
    torch.set_num_threads(1)
    out = {"comm": comm_checks(4)}
    for model in GNN_CASES:
        out[model] = gnn_run(model, world, params[model],
                             os.path.join(ck_root, model))
    return out


def lm_config(num_experts: int = 0):
    """The reduced Mixtral in float32 (optionally with another expert
    count)."""
    import dataclasses
    from repro_torch.config import get_arch_config
    cfg = get_arch_config("mixtral-8x7b").reduced().replace(dtype="float32")
    if num_experts:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  num_experts=num_experts))
    return cfg


def lm_batch() -> dict:
    B, S = LM_BATCH
    rng = np.random.default_rng(1)
    return {k: rng.integers(0, 1024, (B, S)) for k in ("tokens", "labels")}


def lm_run(model) -> dict:
    """A prefill of the batch's tokens (its last logits and the (dropped,
    routed) pairs) and the loss with its gradients, as numpy."""
    from repro_torch.arch.moe import count_drops
    batch = {k: torch.from_numpy(v) for k, v in lm_batch().items()}
    with count_drops() as log:
        logits, _, _ = model.prefill({"tokens": batch["tokens"]},
                                     cache_len=LM_BATCH[1])
    dropped = [int(sum(int(d) for d, _ in log)),
               int(sum(int(r) for _, r in log))]
    model.zero_grad()
    loss = model.loss(batch, chunk=LM_BATCH[1])
    loss.backward()
    return {"logits": logits.numpy().copy(), "dropped": dropped,
            "loss": float(loss.detach()),
            "grads": {n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()}}


def ep_rank(rank: int, world: int, params) -> dict:
    """Model rank ``rank`` of ``world``, one a process
    (``make_host_mesh``): the seeded model's expert stacks, the reduced
    Mixtral on the reference's weights (``params``, the JAX package's
    tree as numpy) through :func:`lm_run`, and the shapes the reference
    refuses."""
    from repro_torch.arch import build_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.weights import lm_params_from_jax
    torch.set_num_threads(1)
    mesh = make_host_mesh(world)
    cfg = lm_config()
    seeded = build_model(cfg, torch.Generator().manual_seed(LM_SEED),
                         moe_impl="ep", mesh=mesh)
    out = {"mesh": (mesh.data, mesh.model, type(mesh.comm).__name__,
                    mesh.comm.count),
           "stacks": {n: p.detach().numpy().copy()
                      for n, p in seeded.named_parameters()
                      if ".ffn.w" in n}}
    model = build_model(cfg, moe_impl="ep", mesh=mesh)
    model.load_state_dict(lm_params_from_jax(cfg, params, mesh),
                          strict=True)
    out.update(lm_run(model))
    raised = {}
    toks = torch.from_numpy(lm_batch()["tokens"])
    _, caches, idx = model.prefill({"tokens": toks[:, :8]}, cache_len=9)
    for name, call in (
            ("decode", lambda: model.decode_step(
                {"tokens": toks[:, 8:9]}, caches, idx)),
            ("sequence", lambda: model.prefill(
                {"tokens": toks[:, :world + 1]}, cache_len=world + 1)),
            ("experts", lambda: build_model(
                lm_config(num_experts=2 * world - 1), moe_impl="ep",
                mesh=mesh))):
        try:
            call()
            raised[name] = ""
        except ValueError as e:
            raised[name] = str(e)
    out["raised"] = raised
    return out
