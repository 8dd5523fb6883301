"""Property-based Sum-stage invariants of the port's public segment
primitives (the twins of ``tests/test_tgar_properties.py``) — needs
hypothesis, behind ``pytest.importorskip`` as the reference's are. Each
property holds on the plain path and on the kernels' route (the plan's
wrappers, their plain versions on CPU tensors)."""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import tgar  # noqa: E402

ROUTES = ("plain", "kernel route")


def _on(route, monkeypatch):
    if route == "kernel route":
        monkeypatch.setattr(tgar, "_on_card", lambda t: True)


@pytest.mark.parametrize("route", ROUTES)
def test_segment_sum_permutation_invariant(route, monkeypatch):
    _on(route, monkeypatch)

    @settings(max_examples=25, deadline=None)
    @given(st.integers(3, 60), st.integers(1, 200),
           st.integers(0, 2 ** 31 - 1))
    def prop(n_seg, n_edges, seed):
        r = np.random.default_rng(seed)
        ids = r.integers(0, n_seg, n_edges)
        data = r.normal(size=(n_edges, 5)).astype(np.float32)
        out = tgar.segment_sum(torch.from_numpy(data),
                               torch.from_numpy(ids), n_seg)
        perm = r.permutation(n_edges)
        out_p = tgar.segment_sum(torch.from_numpy(data[perm]),
                                 torch.from_numpy(ids[perm]), n_seg)
        np.testing.assert_allclose(out.numpy(), out_p.numpy(), rtol=1e-4,
                                   atol=1e-5)
    prop()


@pytest.mark.parametrize("route", ROUTES)
def test_segment_softmax_normalized(route, monkeypatch):
    _on(route, monkeypatch)

    @settings(max_examples=25, deadline=None)
    @given(st.integers(2, 30), st.integers(1, 120),
           st.integers(0, 2 ** 31 - 1))
    def prop(n_seg, n_edges, seed):
        r = np.random.default_rng(seed)
        ids = r.integers(0, n_seg, n_edges)
        logits = r.normal(size=(n_edges, 2)).astype(np.float32) * 5
        values = np.ones((n_edges, 2, 1), np.float32)
        mask = np.ones(n_edges, np.float32)
        out = tgar.segment_softmax(torch.from_numpy(logits),
                                   torch.from_numpy(values),
                                   torch.from_numpy(ids), n_seg,
                                   torch.from_numpy(mask))
        # softmax weights sum to 1 => aggregating ones gives 1 per
        # non-empty segment
        nonempty = np.bincount(ids, minlength=n_seg) > 0
        np.testing.assert_allclose(out.numpy()[nonempty, :, 0], 1.0,
                                   rtol=1e-4, atol=1e-4)
    prop()
