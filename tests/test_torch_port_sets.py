"""Port parity: ops/sets.py and K2's plain version against the JAX package.

Same numpy inputs (from a seeded RandomState) go through the JAX function
and its PyTorch counterpart on the CPU. Tolerances:

- interval params, miss maps, fraction missed, critical λs and both loss
  tables are compared EXACTLY: every step is one correctly rounded IEEE
  operation in both packages;
- the sets themselves within 1 ulp (f32): ``pred − λ·dl`` may be contracted
  into a fused multiply-add by XLA but not by PyTorch's eager ops;
- K2's plain version against the Pallas kernel run in interpret mode, as
  ``tests/test_pallas.py`` runs it: equal miss counts.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im2im_uq_tpu.ops import sets as jsets
from im2im_uq_tpu.ops.pallas_kernels import loss_table_pallas

from im2im_uq_tpu_torch.ops import loss_table as tloss
from im2im_uq_tpu_torch.ops import sets as tsets
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

HEADS_K = {
    "quantiles": 3, "quantiles_l1": 3, "inn": 3,
    "gaussian": 2, "residual_magnitude": 2, "residual_magnitude_l1": 2,
}


def _output(utype: str, seed: int = 0, shape=(2, 9, 11, 1)) -> np.ndarray:
    rng = np.random.RandomState(seed)
    out = rng.randn(shape[0], HEADS_K[utype], *shape[1:]).astype(np.float32)
    if utype == "gaussian":
        out[:, 1] = np.abs(out[:, 1])
    if utype.startswith("residual"):
        out[:, 1] = np.abs(out[:, 1])
    if HEADS_K[utype] == 3:
        out[0, 0, :2] = out[0, 1, :2]  # collapsed lower edge: the 1e-6 clamp
        out[1, 2, :, :3] = out[1, 1, :, :3] - 1.0  # inverted upper edge
    return out


def _params(seed=3, B=5, H=30, W=25, zero_slopes=True):
    rng = np.random.RandomState(seed)
    pred = rng.randn(B, H, W, 1).astype(np.float32)
    dl = np.abs(rng.randn(B, H, W, 1)).astype(np.float32)
    du = np.abs(rng.randn(B, H, W, 1)).astype(np.float32)
    if zero_slopes:
        dl[0, :3] = 0.0
        du[min(1, B - 1), :, :2] = 0.0
    labels = rng.randn(B, H, W, 1).astype(np.float32)
    return (pred, dl, du), labels


def _jp(params):
    return jsets.IntervalParams(*map(jnp.asarray, params))


def _tp(params):
    return tsets.IntervalParams(*map(torch.from_numpy, params))


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _within_ulp(t: torch.Tensor, j) -> None:
    a, b = t.numpy(), np.asarray(j)
    np.testing.assert_array_max_ulp(a, b, maxulp=1)


@pytest.mark.parametrize("utype", sorted(HEADS_K))
def test_interval_params_match_jax(utype):
    out = _output(utype)
    got = tsets.interval_params(torch.from_numpy(out), utype)
    want = jsets.interval_params(jnp.asarray(out), utype)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("lam", [0.0, 0.37, 1.0, 5.5])
def test_sets_miss_and_fraction_match_jax(lam):
    out = _output("quantiles", seed=1)
    label = np.random.RandomState(2).randn(2, 9, 11, 1).astype(np.float32)
    got = tsets.nested_sets_from_output(torch.from_numpy(out), lam, "quantiles")
    want = jsets.nested_sets_from_output(jnp.asarray(out), jnp.float32(lam), "quantiles")
    for g, w in zip(got, want):
        _within_ulp(g, w)
    # the miss map and fraction missed on the SAME sets: exact
    lo, hi = np.asarray(want[0]), np.asarray(want[2])
    tl, th, ty = map(torch.from_numpy, (lo, hi, label))
    _eq(tsets.miss_map(tl, th, ty), jsets.miss_map(lo, hi, jnp.asarray(label)))
    _eq(tsets.fraction_missed(tl, th, ty), jsets.fraction_missed(lo, hi, jnp.asarray(label)))


def test_softmax_head_is_not_ported():
    """The softmax head is ported now (``test_torch_port_heads.py``); what
    stays refused is an unknown type, with the JAX package's error."""
    out = np.zeros((1, 50, 2, 2, 1), np.float32)
    with pytest.raises(NotImplementedError, match="unknown uncertainty_type 'bogus'"):
        jsets.interval_params(jnp.asarray(out), "bogus")
    with pytest.raises(NotImplementedError, match="unknown uncertainty_type 'bogus'"):
        tsets.interval_params(torch.from_numpy(out), "bogus")
    params = tsets.interval_params(torch.from_numpy(out), "softmax")
    assert [tuple(p.shape) for p in params] == [(1, 2, 2, 1)] * 3


def test_critical_lambdas_match_jax():
    params, labels = _params()
    _eq(
        tsets.critical_lambdas(_tp(params), torch.from_numpy(labels)),
        jsets.critical_lambdas(_jp(params), jnp.asarray(labels)),
    )


@pytest.mark.parametrize("method", ["direct", "fast"])
@pytest.mark.parametrize("L", [7, 128, 173])
def test_rcps_loss_table_matches_jax(method, L):
    params, labels = _params()
    lam = np.linspace(0.0, 3.0, L)
    got = tsets.rcps_loss_table(_tp(params), torch.from_numpy(labels), lam, method=method)
    want = jsets.rcps_loss_table(_jp(params), jnp.asarray(labels), lam, method=method)
    assert got.shape == (5, L)
    _eq(got, want)


def _flat(params, labels):
    n = labels.shape[0]
    pred, dl, du = (torch.from_numpy(a.reshape(n, -1)) for a in params)
    return pred, torch.from_numpy(labels.reshape(n, -1)), dl, du


@pytest.mark.parametrize("L", [7, 128, 173])
def test_k2_plain_matches_pallas_interpret(L):
    params, labels = _params()
    lam = np.linspace(0.0, 3.0, L).astype(np.float32)
    before = tloss.loss_table.launches
    got = tloss.loss_table(*_flat(params, labels), torch.from_numpy(lam))
    assert tloss.loss_table.launches == before  # a CPU tensor never launches
    want = np.asarray(loss_table_pallas(_jp(params), jnp.asarray(labels), jnp.asarray(lam),
                                        interpret=True))
    num_px = int(np.prod(labels.shape[1:]))
    np.testing.assert_array_equal(
        np.round(got.numpy() * num_px), np.round(want * num_px)
    )
    _eq(got, want)


def test_k2_plain_tiny_batch_and_tiny_lambda():
    params, labels = _params(B=1, H=9, W=11)
    lam = np.asarray([0.0, 0.5], np.float32)
    got = tloss.loss_table(*_flat(params, labels), torch.from_numpy(lam))
    want = np.asarray(loss_table_pallas(_jp(params), jnp.asarray(labels), jnp.asarray(lam),
                                        interpret=True))
    _eq(got, want)


def test_k2_plain_chunks_over_lambda(monkeypatch):
    """A chunk smaller than the grid gives the same table as one chunk."""
    params, labels = _params(B=2, H=7, W=6)
    lam = torch.linspace(0.0, 3.0, 37)
    whole = tloss.loss_table_plain(*_flat(params, labels), lam)
    monkeypatch.setattr(tloss, "_PLAIN_CHUNK_ELEMS", 2 * 7 * 6 * 5)
    _eq(tloss.loss_table_plain(*_flat(params, labels), lam), whole.numpy())


def test_pallas_method_routes_to_k2_wrapper():
    params, labels = _params(B=3, H=8, W=5)
    lam = np.linspace(0.0, 2.0, 19)
    got = tsets.rcps_loss_table(_tp(params), torch.from_numpy(labels), lam, method="pallas")
    want = jsets.rcps_loss_table(_jp(params), jnp.asarray(labels), lam, method="pallas")
    _eq(got, want)


def test_k2_wrapper_rejects_other_devices():
    meta = torch.empty((2, 4), device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tloss.loss_table(meta, meta, meta, meta, torch.empty(3, device="meta"))
