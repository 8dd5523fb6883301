"""The port's GNN server on the CPU: parity with the JAX package's server,
the cache-hit contract, batching, shutdown and update semantics (the
counterparts of ``tests/test_serving.py``), and the CLI entry point."""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.config import GNNConfig as JaxConfig
from repro.graph.datasets import make_dataset as jax_dataset
from repro.models import make_gnn as jax_make_gnn
from repro.serving import GNNServer as JaxServer
import repro_torch.api as api
from repro_torch.config import GNNConfig
from repro_torch.core.mpgnn import forward_block
from repro_torch.device import resolve_device
from repro_torch.graph import base_block, make_dataset
from repro_torch.launch.serve_gnn import (build_server, main,
                                          request_trace, resolve_graph,
                                          run_clients)
from repro_torch.models import make_gnn
from repro_torch.nn.layers import fixed_row_tiles
from repro_torch.serving import (GNNServer, ServerClosedError,
                                 ServerOverloadedError)
from repro_torch.weights import params_from_jax

# (dataset, config kwargs): GAT-E at its published widths, GCN at hidden 128
SETUPS = {
    "gat_e": ("alipay_like", dict(model="gat_e", hidden_dim=32, num_heads=4,
                                  edge_feature_dim=8)),
    "gcn": ("reddit_like", dict(model="gcn", hidden_dim=128)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _graphs(key):
    dataset, kw = SETUPS[key]
    jg = jax_dataset(dataset, seed=0, num_nodes=300)
    pg = make_dataset(dataset, seed=0, num_nodes=300)
    if kw["model"] == "gcn":
        jg, pg = jg.add_self_loops(), pg.add_self_loops()
    return jg, pg


def _models(key, g):
    _, kw = SETUPS[key]
    common = dict(num_layers=2, num_classes=int(g.labels.max()) + 1,
                  feature_dim=g.node_features.shape[1], **kw)
    jmodel = jax_make_gnn(JaxConfig(aggregate_backend="reference", **common))
    params = jmodel.init(jax.random.PRNGKey(0), common["feature_dim"])
    return jmodel, params, make_gnn(GNNConfig(**common))


@pytest.fixture(scope="module")
def gat_e():
    """A port server setup: (graph, model, state_dict) for GAT-E."""
    _, g = _graphs("gat_e")
    _, params, model = _models("gat_e", g)
    return g, model, params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            params))


def _server(setup, **kw):
    g, model, sd = setup
    kw.setdefault("max_batch", 8)
    return GNNServer(model, sd, g, gcn_norm=False, device="cpu", **kw)


@pytest.mark.parametrize("key", sorted(SETUPS))
def test_server_matches_jax_server(key):
    jg, pg = _graphs(key)
    jmodel, params, model = _models(key, pg)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    gcn = key == "gcn"
    jsrv = JaxServer(jmodel, params, jg, max_batch=8, gcn_norm=gcn)
    srv = GNNServer(model, sd, pg, max_batch=8, gcn_norm=gcn, device="cpu")
    trace = request_trace(pg, 40, seed=5)
    np.testing.assert_array_equal(trace, request_trace(jg, 40, seed=5))
    # repeated batches, so both servers serve cache hits as well
    for batch in (trace[:8], trace[8:20], trace[:8], trace[20:], trace[8:20]):
        np.testing.assert_allclose(srv.submit(batch), jsrv.submit(batch),
                                   rtol=1e-4, atol=1e-4)
    assert srv.cache.stats()["hits"] == jsrv.cache.stats()["hits"] > 0


def test_cache_hit_equals_full_recompute_bitwise_on_cpu(gat_e):
    """On the CPU the cache hit is bitwise equal to the full recompute
    (asserted), and within 1e-6 (the contract the card is held to in
    ``chip_smoke.py`` at its own tolerance)."""
    g = gat_e[0]
    targets = np.random.default_rng(0).choice(g.num_nodes, 12, replace=False)
    cached = _server(gat_e)
    plain = _server(gat_e, cache=False)
    first = cached.submit(targets)
    again = cached.submit(targets)
    assert cached.cache.stats()["hits"] > 0
    full = plain.submit(targets)
    np.testing.assert_allclose(again, full, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(again, full)
    # and the whole-graph forward gives the same rows
    with torch.no_grad():
        offline = forward_block(cached.model,
                                base_block(g, gcn_norm=False, csc_plan=True))
    np.testing.assert_allclose(again, offline[targets].numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("model", ["gat", "gat_e"])
def test_attention_halves_do_not_depend_on_the_block(model):
    """A node's attention-logit halves (``as``, ``ad``) and messages from
    a GAT or GAT-E layer's ``transform``, under the server's fixed row
    tiles, are the same bits whether the node comes in a block of 1, 7,
    4,096 or 40,000 rows: a cache hit runs the top layer on a smaller
    block than the full recompute (the halves were an ``einsum`` over
    the N rows, whose kernel the card picks by N)."""
    cfg = GNNConfig(model=model, num_layers=2, hidden_dim=32, num_classes=2,
                    feature_dim=24, num_heads=4, edge_feature_dim=8)
    layer = make_gnn(cfg, seed=0).layers[1]
    h = torch.randn(40_000, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), fixed_row_tiles(len(h)):
        full = layer.transform(h)
        for rows in (1, 7, 4096):
            part = layer.transform(h[:rows].clone())
            for k in ("n", "as", "ad"):
                assert torch.equal(part[k], full[k][:rows]), (rows, k)


def test_concurrent_clients_deterministic(gat_e):
    trace = request_trace(gat_e[0], 48, seed=4)

    def serve_with(clients):
        srv = _server(gat_e, max_batch=4, max_wait_ms=1.0).start()
        try:
            out, _ = run_clients(srv, trace, clients)
        finally:
            srv.stop()
        return out

    np.testing.assert_array_equal(serve_with(1), serve_with(4))


def test_request_requires_start_and_submit_validates(gat_e):
    srv = _server(gat_e)
    with pytest.raises(RuntimeError):
        srv.request(0)
    with pytest.raises(ValueError):
        srv.submit([])
    with pytest.raises(ValueError):
        srv.submit([gat_e[0].num_nodes])


def _queue_clients(srv, n):
    errs = []

    def client(i):
        try:
            srv.request(i)
        except Exception as e:  # noqa: BLE001 — collected for assertion
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 5.0
    while len(srv._queue) < n:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    return threads, errs


def test_close_fails_queued_requests_and_refuses_new(gat_e):
    # a huge deadline + batch keeps everything queued until close()
    srv = _server(gat_e, max_batch=64, max_wait_ms=10_000.0).start()
    threads, errs = _queue_clients(srv, 5)
    srv.close()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert len(errs) == 5
    assert all(isinstance(e, ServerClosedError) for e in errs)
    for call in (lambda: srv.request(0), lambda: srv.submit([0]), srv.start):
        with pytest.raises(ServerClosedError):
            call()
    srv.close()                             # idempotent


def test_bounded_queue_sheds_load_typed(gat_e):
    srv = _server(gat_e, max_batch=64, max_wait_ms=10_000.0,
                  max_queue=2).start()
    try:
        threads, errs = _queue_clients(srv, 2)
        with pytest.raises(ServerOverloadedError, match="back off"):
            srv.request(2)
    finally:
        srv.close()
        for t in threads:
            t.join(10)
    assert len(errs) == 2
    assert all(isinstance(e, ServerClosedError) for e in errs)


def _bumped(sd, delta, prefix="layers.0."):
    return {k: (v + delta if k.startswith(prefix) else v)
            for k, v in sd.items()}


def test_stale_cache_bounded_drift_and_strict_exactness(gat_e):
    g, _, sd = gat_e
    targets = np.random.default_rng(1).choice(g.num_nodes, 12, replace=False)
    bumped = _bumped(sd, 1e-3)
    srv = _server(gat_e, staleness=1)
    srv.submit(targets)                     # cache under the old params
    srv.update_params(bumped)
    h0 = srv.cache.stats()["hits"]
    served = srv.submit(targets)
    assert srv.cache.stats()["hits"] > h0   # stale entries still admit
    oracle = _server(gat_e, cache=False)
    oracle.update_params(bumped)
    exact = oracle.submit(targets)
    drift = np.abs(served - exact).max()
    assert 0 < drift < 0.1, drift
    strict = _server(gat_e)
    strict.submit(targets)
    strict.update_params(bumped)
    h0 = strict.cache.stats()["hits"]
    np.testing.assert_array_equal(strict.submit(targets), exact)
    assert strict.cache.stats()["hits"] == h0


def test_param_swap_never_blends(gat_e):
    g, _, sd = gat_e
    targets = np.random.default_rng(5).choice(g.num_nodes, 10, replace=False)
    sd_b = {k: v + 1e-2 for k, v in sd.items()}
    oracle = _server(gat_e, cache=False)
    out_a = oracle.submit(targets)
    oracle.update_params(sd_b)
    out_b = oracle.submit(targets)
    assert np.abs(out_a - out_b).max() > 0
    srv = _server(gat_e)
    srv.submit(targets)
    stop = threading.Event()
    bad = []

    def swapper():
        flip = True
        while not stop.is_set():
            srv.update_params(sd_b if flip else sd)
            flip = not flip

    def hammer():
        for _ in range(8):
            out = srv.submit(targets)
            if not (np.array_equal(out, out_a) or np.array_equal(out, out_b)):
                bad.append(out)

    sw = threading.Thread(target=swapper)
    hs = [threading.Thread(target=hammer) for _ in range(3)]
    sw.start()
    for h in hs:
        h.start()
    for h in hs:
        h.join(60)
        assert not h.is_alive()
    stop.set()
    sw.join(10)
    assert not bad, "served a blend of two param versions"


def test_feature_update_invalidates_dependents():
    _, g = _graphs("gat_e")
    _, params, model = _models("gat_e", g)
    setup = (g, model, params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    targets = np.random.default_rng(3).choice(g.num_nodes, 10, replace=False)
    srv = _server(setup)
    srv.submit(targets)
    node = int(targets[0])
    srv.update_features(np.array([node]), g.node_features[node] + 0.5)
    served = srv.submit(targets)
    np.testing.assert_array_equal(served,
                                  _server(setup, cache=False).submit(targets))


def test_k1_model_has_no_cache():
    _, g = _graphs("gat_e")
    srv = build_server(g, "gat_e", 1, 32, device="cpu")
    assert srv.cache is None
    assert srv.submit(np.arange(5)).shape == (5, 2)


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    _, g = _graphs("gat_e")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(g, "gat_e", 2, 32)
    assert resolve_device("cpu").type == "cpu"


def test_serve_gnn_main_runs_on_cpu(capsys):
    assert main(["--dataset", "cora", "--model", "gcn", "--hidden", "16",
                 "--requests", "24", "--clients", "2", "--device",
                 "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 24 requests" in out and "[cpu]" in out


@pytest.mark.parametrize("source", ["steps", "checkpoint"])
def test_serve_gnn_main_trains_or_serves_a_checkpoint(source, tmp_path,
                                                      capsys):
    """``--steps 5`` trains before serving; ``--checkpoint-dir`` serves
    that checkpoint's params, the trained ones, over seeded weights."""
    from repro_torch.launch.train import main as train_main
    job = ["--dataset", "cora", "--model", "gcn", "--hidden", "16",
           "--device", "cpu"]
    serve = job + ["--requests", "24", "--clients", "2"]
    if source == "steps":
        assert main(serve + ["--steps", "5"]) == 0
        out = capsys.readouterr().out
        assert "trained 5 steps" in out and "served 24 requests" in out
        return
    ck = str(tmp_path / "ck")
    assert train_main(["gnn", *job, "--steps", "3", "--checkpoint-dir", ck,
                       "--checkpoint-every", "3"]) == 0
    assert main(serve + ["--checkpoint-dir", ck]) == 0
    assert "served 24 requests" in capsys.readouterr().out
    g = resolve_graph("cora", "gcn")
    targets = np.arange(6)
    params = api.checkpoint_params(ck)
    server = build_server(g, "gcn", 2, 16, device="cpu", params=params,
                          cache=False)
    assert all(torch.equal(server.model.state_dict()[k], params[k])
               for k in params)
    seeded = build_server(g, "gcn", 2, 16, device="cpu", cache=False)
    assert not np.array_equal(server.submit(targets),
                              seeded.submit(targets))
