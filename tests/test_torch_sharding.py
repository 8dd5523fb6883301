"""The dry-run planner's rules in the port against the JAX package's, on
the CPU: the config's workloads and analytic parameter counts, the
auto-FSDP specs of every parameter, cache and input leaf, the activation
hints, and the roofline's ``model_flops`` and collective plan.

The port unrolls the reference's stacked blocks, so a port leaf
``blocks.<g * len(slots) + s>.<path>`` is the reference's ``blocks/<s>/
<path>`` at stack index ``g`` and its spec is the reference's without
the stack dim's entry. The shapes on both sides are shape-only: the
reference's ``param_shapes``/``eval_shape`` and the port's model built
on fake tensors (:func:`repro_torch.launch.faketrace.fake_model`).

The analytic ``param_count`` is the reference's formula, equal on both
sides; it counts the products' weights and not the norms, biases,
RWKV's token-shift mixes or Mamba's ``dt_bias``/``D``, and it counts
Whisper's MLP as a SwiGLU, so it is not a model's numel: on the reduced
configs the built models hold 1,280 (Mixtral, DBRX, Phi-3, Qwen2-VL) to
137,472 (RWKV-6) parameters more, Jamba 10,192 and Whisper 515,072
fewer. The port's shape-only build is held to the reference's built
leaves instead, name for name and shape for shape.
"""
import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.config as jcfg_mod  # noqa: E402
from repro.arch import build_model as jax_build_model  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402

from repro_torch import config as cfg_mod  # noqa: E402
from repro_torch.arch import hints  # noqa: E402
from repro_torch.launch import roofline, sharding as sh  # noqa: E402
from repro_torch.launch.faketrace import fake_model  # noqa: E402
from repro_torch.launch.mesh import (ShapeMesh, data_axes,  # noqa: E402
                                     make_production_mesh)

ARCHS = cfg_mod.ASSIGNED_ARCHS
MESHES = [ShapeMesh(("data", "model"), (16, 16)),
          ShapeMesh(("pod", "data", "model"), (2, 16, 16)),
          ShapeMesh(("data", "model"), (32, 8)),
          ShapeMesh(("pod", "data", "model"), (2, 32, 8))]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ref_dryrun():
    """``repro.launch.dryrun``, imported without keeping the 512-device
    XLA flag it sets at import for its own process."""
    prev = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return mod


def _flat(tree):
    """{"a/b/0/c": leaf} of a JAX pytree (specs kept whole)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path): leaf for path, leaf in flat}


def _flat_dicts(tree, prefix=""):
    """{"a/b": leaf} of nested dicts (a port spec, a tuple, is a leaf)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat_dicts(v, path) if isinstance(v, dict)
                   else {path: v})
    return out


def _port_to_ref(name: str, n_slots: int):
    """(reference path, stack index or None) of a port leaf name."""
    parts = name.split(".")
    if parts[0] == "blocks":
        i = int(parts[1])
        return "/".join(["blocks", str(i % n_slots)] + parts[2:]), \
            i // n_slots
    if parts[0] == "encoder":
        return "/".join(["encoder"] + parts[2:]), int(parts[1])
    return "/".join(parts), None


_BUILT = {}


def _models(arch, reduced=False):
    """(reference model, its param shapes, the port's fake model)."""
    key = (arch, reduced)
    if key not in _BUILT:
        jc = jcfg_mod.get_arch_config(arch)
        pc = cfg_mod.get_arch_config(arch)
        if reduced:
            jc, pc = jc.reduced(), pc.reduced()
        jm = jax_build_model(jc)
        _, pm = fake_model(pc)
        _BUILT.clear()
        _BUILT[key] = (jm, jm.param_shapes(), pm)
    return _BUILT[key]


def test_workloads_and_archs_equal_the_reference():
    assert cfg_mod.ASSIGNED_ARCHS == jcfg_mod.ASSIGNED_ARCHS
    assert set(cfg_mod.INPUT_SHAPES) == set(jcfg_mod.INPUT_SHAPES)
    for k, s in cfg_mod.INPUT_SHAPES.items():
        r = jcfg_mod.INPUT_SHAPES[k]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            r.name, r.seq_len, r.global_batch, r.kind)
    assert list(cfg_mod.list_arch_configs()) == ARCHS


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch, reduced):
    jc, pc = jcfg_mod.get_arch_config(arch), cfg_mod.get_arch_config(arch)
    if reduced:
        jc, pc = jc.reduced(), pc.reduced()
    assert pc.param_count() == jc.param_count()
    assert pc.active_param_count() == jc.active_param_count()
    assert pc._layer_split() == jc._layer_split()
    if reduced:
        # the shape-only build holds the reference's leaves, unrolled
        _, shapes, pm = _models(arch, reduced=True)
        n_slots = len(shapes["blocks"])
        ref = _flat(shapes)
        got = {}
        for k, p in pm.named_parameters():
            path, g = _port_to_ref(k, n_slots)
            got.setdefault(path, []).append((g, tuple(p.shape)))
        assert set(got) == set(ref)
        for path, leaf in ref.items():
            for g, shp in got[path]:
                want = tuple(leaf.shape[1:]) if g is not None \
                    else tuple(leaf.shape)
                assert shp == want, (path, g, shp, want)
        numel = sum(p.numel() for p in pm.parameters())
        assert numel == sum(math.prod(x.shape) for x in ref.values())


def _check_divisible(shape, spec, mesh):
    for dim, axis in zip(shape, spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        assert dim % math.prod(mesh.shape[a] for a in axes) == 0, (
            shape, spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference_leaf_for_leaf(arch):
    """At four meshes, FSDP and the serving layout: every port leaf's spec
    is its reference leaf's less the stack dim, and divides its dims."""
    _, shapes, pm = _models(arch)
    params = dict(pm.named_parameters())
    n_slots = len(shapes["blocks"])
    for mesh in MESHES:
        for dp in (data_axes(mesh), ()):
            want = _flat(jsh.param_specs(shapes, mesh, dp))
            got = sh.param_specs(params, mesh, dp)
            assert len(got) == len(params)
            for k, spec in got.items():
                path, g = _port_to_ref(k, n_slots)
                ref = tuple(want[path])
                assert spec == (ref[1:] if g is not None else ref), (
                    mesh, dp, k, spec, ref)
                _check_divisible(params[k].shape, spec, mesh)


@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-1.5-large-398b",
                                  "minicpm3-4b", "rwkv6-1.6b"])
def test_cache_specs_equal_the_reference(arch):
    jm, shapes, pm = _models(arch)
    n_slots = len(shapes["blocks"])
    ref = jax.eval_shape(lambda: jm.init_cache(128, 32768))
    mode = pm.embed["table"].fake_mode
    with mode:
        caches = pm.init_cache(128, 32768)
    for mesh in MESHES:
        dp = data_axes(mesh)
        want = jsh.cache_specs(ref, mesh, dp)
        got = sh.cache_specs(caches, mesh, dp)
        assert len(got) == len(caches) == pm.cfg.num_layers
        for i, (layer, specs) in enumerate(zip(caches, got)):
            slot = _flat(want[i % n_slots])
            flat_c = _flat(layer)
            flat_s = _flat_dicts(specs)
            assert set(flat_s) == set(slot)
            for path, spec in flat_s.items():
                assert spec == tuple(slot[path])[1:], (mesh, i, path)
                _check_divisible(flat_c[path].shape, spec, mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_reference(arch, monkeypatch):
    """The step's inputs (names, shapes, dtypes) and their specs, as the
    reference's ``input_specs`` makes them (its ``named`` captured)."""
    from repro_torch.launch.dryrun import input_specs
    ref = _ref_dryrun()
    monkeypatch.setattr(ref.sh, "named", lambda tree, specs, mesh: (tree,
                                                                   specs))
    jc, pc = jcfg_mod.get_arch_config(arch), cfg_mod.get_arch_config(arch)
    for name, shape in cfg_mod.INPUT_SHAPES.items():
        for mesh in MESHES:
            with torch.device("meta"):
                batch, specs = input_specs(pc, shape, mesh)
            jbatch, jspecs = ref.input_specs(jc, jcfg_mod.INPUT_SHAPES[name],
                                             mesh, None)
            assert set(batch) == set(jbatch)
            for k, v in batch.items():
                assert tuple(v.shape) == jbatch[k].shape
                assert str(v.dtype).split(".")[-1] == str(jbatch[k].dtype)
                assert specs[k] == tuple(jspecs[k]), (name, mesh, k)
                _check_divisible(v.shape, specs[k], mesh)


def test_production_mesh_is_shape_only():
    single, multi = (make_production_mesh(),
                     make_production_mesh(multi_pod=True))
    assert single.shape == {"data": 32, "model": 8} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 32, "model": 8}
    assert multi.size == 512
    assert data_axes(single) == ("data",)
    assert data_axes(multi) == ("pod", "data")
    with pytest.raises(ValueError):
        ShapeMesh(("data",), (4,))


# -- activation hints ---------------------------------------------------------


def _ref_hint_spec(monkeypatch, mesh, rules, x, logical):
    """The spec the reference's armed ``shard_hint`` hands
    ``with_sharding_constraint`` (captured, not applied)."""
    import repro.arch.hints as jh
    seen = {}

    def capture(a, sharding):
        seen["spec"] = tuple(sharding.spec)
        return a
    monkeypatch.setattr(jh.jax.lax, "with_sharding_constraint", capture)
    monkeypatch.setattr(jh.jax.sharding, "NamedSharding",
                        lambda m, spec: type("S", (), {"spec": spec})())
    with jh.use_hints(mesh, rules):
        jh.shard_hint(jax.ShapeDtypeStruct(x.shape, np.float32), *logical)
    return seen["spec"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: str(m.sizes))
def test_shard_hint_resolves_as_the_reference(mesh, monkeypatch):
    import repro.arch.hints as jh
    ref = _ref_dryrun()
    for seq_shard in (True, False):
        rules = ref.hint_rules(mesh, seq_shard)
        from repro_torch.launch.dryrun import hint_rules
        assert hint_rules(mesh, seq_shard) == rules
        for shape, logical in [((256, 4096, 2560), ("batch", "seq", None)),
                               ((32, 32768, 2560), ("batch", "seq", None)),
                               ((1, 1, 2560), ("batch", "seq", None)),
                               ((128, 1, 151936), ("batch", None, "vocab")),
                               ((64, 4096, 8192),
                                ("batch", None, "heads_flat"))]:
            x = torch.empty(shape, device="meta")
            want = _ref_hint_spec(monkeypatch, mesh, rules, x, logical)
            with hints.use_hints(mesh, rules) as sites:
                assert hints.shard_hint(x, *logical) is x
            assert sites == [(logical, shape, want)]
    x = torch.empty((2, 3), device="meta")
    with hints.use_hints(mesh, {"batch": "data"}):
        with pytest.raises(ValueError, match="rank"):
            hints.shard_hint(x, "batch")
    with jh.use_hints(mesh, {"batch": "data"}):
        with pytest.raises(ValueError, match="rank"):
            jh.shard_hint(jax.ShapeDtypeStruct((2, 3), np.float32),
                          "batch")
    assert hints.shard_hint(x, "batch") is x        # unarmed: a no-op


def test_armed_forward_is_bitwise_the_unarmed_one():
    from repro_torch.arch import build_model
    from repro_torch.launch.dryrun import hint_rules
    cfg = cfg_mod.get_arch_config("jamba-1.5-large-398b").reduced().replace(
        dtype="float32")
    model = build_model(cfg, torch.Generator().manual_seed(0), remat=False)
    tok = torch.randint(0, cfg.vocab_size, (2, 32),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": tok}
    want = model.loss(batch, chunk=16)
    mesh = MESHES[0]
    with hints.use_hints(mesh, hint_rules(mesh)) as sites:
        got = model.loss(batch, chunk=16)
    assert torch.equal(got, want)
    kinds = {s[0] for s in sites}
    assert kinds == {("batch", "seq", None), ("batch", None, "vocab"),
                     ("batch", None, "heads_flat")}


# -- the roofline -------------------------------------------------------------


def test_model_flops_equal_the_reference():
    for arch in ARCHS:
        jc, pc = jcfg_mod.get_arch_config(arch), cfg_mod.get_arch_config(arch)
        for name, shape in cfg_mod.INPUT_SHAPES.items():
            for chips in (1, 256, 512):
                assert roofline.model_flops(pc, shape, chips) == \
                    jroof.model_flops(jc, jcfg_mod.INPUT_SHAPES[name], chips)


def test_collective_bytes_closed_forms():
    """One leaf of 2 * 64 * 32 bytes (bf16) sharded (data, model) on a
    (4, 8) mesh, then ((pod, data), model) on (2, 4, 8)."""
    p = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    nb = 64 * 32 * 2
    mesh = ShapeMesh(("data", "model"), (4, 8))
    specs = {"w": ("data", "model")}
    fwd = roofline.collective_bytes({"w": p}, specs, mesh, False, False)
    # data first over the network: 3/4 of the model shard; model: 7/8
    assert fwd["network"] == pytest.approx(3 / 4 * nb / 8)
    assert fwd["nvlink"] == pytest.approx(7 / 8 * nb)
    assert fwd["all-gather"] == pytest.approx((1 - 1 / 32) * nb)
    tr = roofline.collective_bytes({"w": p}, specs, mesh, True, True)
    assert tr["all-gather"] == pytest.approx(2 * (1 - 1 / 32) * nb)
    assert tr["reduce-scatter"] == pytest.approx((1 - 1 / 32) * nb)
    assert tr["all-reduce"] == 0
    assert tr["total"] == pytest.approx(3 * (1 - 1 / 32) * nb)
    # replicated over model: the gradient shard all-reduced over NVLink
    rep = roofline.collective_bytes({"w": p}, {"w": ("data", None)}, mesh,
                                    True, False)
    assert rep["all-reduce"] == pytest.approx(2 * 7 / 8 * nb / 4)
    assert rep["nvlink"] == pytest.approx(2 * 7 / 8 * nb / 4)
    assert rep["network"] == pytest.approx(2 * 3 / 4 * nb)
    # over pod too
    m3 = ShapeMesh(("pod", "data", "model"), (2, 4, 8))
    t3 = roofline.collective_bytes({"w": p}, {"w": (("pod", "data"),
                                                    "model")}, m3, True,
                                   False)
    ag = 1 / 2 * nb / 32 + 3 / 4 * nb / 8 + 7 / 8 * nb
    assert t3["all-gather"] == pytest.approx(ag)
    assert t3["all-gather"] == pytest.approx((1 - 1 / 64) * nb)
    t4 = roofline.collective_bytes({"w": p}, {"w": ("data", "model")}, m3,
                                   True, False)
    assert t4["all-reduce"] == pytest.approx(2 * 1 / 2 * nb / 32)


def test_derive_terms_closed_forms():
    from repro_torch.launch import mesh as hw
    shape = cfg_mod.INPUT_SHAPES["train_4k"]
    cfg = cfg_mod.get_arch_config("qwen3-4b")
    cost = {"flops": 2e15, "bytes": 1e12,
            "coll": {"nvlink": 9e10, "network": 5e9, "total": 9.5e10}}
    t = roofline.derive_terms("qwen3-4b", shape, "single", 256, cost,
                              3e10, cfg)
    assert t.t_compute_s == pytest.approx(2e15 / hw.PEAK_FLOPS_BF16)
    assert t.t_memory_s == pytest.approx(1e12 / hw.HBM_BW)
    assert t.t_nvlink_s == pytest.approx(9e10 / hw.NVLINK_BW)
    assert t.t_network_s == pytest.approx(5e9 / hw.NET_BW)
    assert t.t_collective_s == pytest.approx(t.t_nvlink_s + t.t_network_s)
    assert t.dominant == "compute" and t.bound_s == t.t_compute_s
    assert t.useful_flops_ratio == pytest.approx(
        roofline.model_flops(cfg, shape, 256) / 2e15)
    assert t.memory_per_device_bytes == 3e10
