"""The mixture-of-experts FFN of the PyTorch port against the JAX package,
on the CPU.

The same seeded numpy inputs and params go through
``pio_tpu.ops.moe.moe_ffn`` (one-hot einsums) and the port's
``moe_ffn`` (index form): the outputs, the load-balance loss, the routing
(expert, rank in the expert's queue, kept or dropped) and the gradients
of ``sum(y * w) + aux`` with respect to x and all five params agree; a
capacity that drops tokens drops the same tokens in both, as exact zeros.
The port's index form is also held to its own literal one-hot form, the
plain version ``chip_smoke.py`` holds it to on the card.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.ops import moe as ref
from pio_tpu_torch.ops import moe as port

# y and aux from the same inputs and params: the experts' products summed
# in other orders by XLA and torch (measured 3.6e-7 on y of |y| <= 2.4,
# 1.2e-7 on aux)
ATOL = 1e-6
# gradients: the same products transposed, summed over the tokens of an
# expert (measured below 1e-6 on these sizes)
GRAD_ATOL = 1e-5
# the smallest gap allowed between a token's two largest router
# probabilities, so the argmax cannot flip on rounding
MIN_ROUTER_GAP = 1e-5
PARAMS = ("router", "w_in", "b_in", "w_out", "b_out")

# (tokens, d_model, d_ff, experts, capacity factor, seed); capacities
# that keep every token and that drop some
CASES = [
    (96, 16, 32, 4, 8.0, 0),
    (96, 16, 32, 4, 2.0, 1),
    (127, 32, 64, 4, 1.0, 2),
    (200, 16, 32, 8, 1.25, 3),
]
DROP_CASES = [
    (96, 16, 32, 4, 0.5, 4),
    (127, 32, 64, 4, 0.25, 5),
    (64, 8, 16, 2, 1e-9, 6),
]


def _inputs(t, d, f, e, seed):
    """x (T, D) and the five params, numpy f32, at the reference's
    scales (biases nonzero, so their gradients and slot effects show)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_in": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "b_in": 0.1 * rng.standard_normal((e, f)),
         "w_out": rng.standard_normal((e, f, d)) / np.sqrt(f),
         "b_out": 0.1 * rng.standard_normal((e, d))}
    return x, {k: v.astype(np.float32) for k, v in p.items()}


def _ref(x, p, cfg):
    y, aux = ref.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), ref.MoEConfig(*cfg))
    return np.asarray(y), float(aux)


def _ref_routing(x, p, cfg):
    """The reference's expert a token and, for kept tokens, its slot,
    read off its dispatch tensor."""
    e, cap = cfg[0], ref._capacity(x.shape[0], cfg[0], cfg[3])
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1)
    dispatch, _, _ = ref._route(jnp.asarray(x), jnp.asarray(p["router"]),
                                e, cap)
    dispatch = np.asarray(dispatch)
    keep = dispatch.reshape(len(x), -1).sum(1) > 0
    slot = dispatch.reshape(len(x), -1).argmax(1)
    return (np.asarray(jnp.argmax(probs, -1)), slot // cap, slot % cap,
            keep, np.asarray(probs))


def _torch(p):
    return {k: torch.tensor(v) for k, v in p.items()}


def _cfg(t, d, f, e, cf):
    return (e, d, f, cf)


@pytest.mark.parametrize("case", CASES + DROP_CASES)
def test_moe_ffn_equals_reference(case):
    t, d, f, e, cf, seed = case
    x, p = _inputs(t, d, f, e, seed)
    cfg = _cfg(t, d, f, e, cf)
    want_y, want_aux = _ref(x, p, cfg)
    got_y, got_aux = port.moe_ffn(_torch(p), torch.tensor(x),
                                  port.MoEConfig(*cfg))
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=0, atol=ATOL)
    assert abs(float(got_aux) - want_aux) <= ATOL
    # the routing: the same expert for every token, the same slot for
    # every kept one
    expert, slot_e, slot_c, keep, probs = _ref_routing(x, p, cfg)
    top2 = np.sort(probs, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > MIN_ROUTER_GAP
    cap = port._capacity(t, e, cf)
    assert cap == ref._capacity(t, e, cf)
    g_expert, g_pos, _, g_keep, _ = port.route(
        torch.tensor(x), torch.tensor(p["router"]), e, cap)
    np.testing.assert_array_equal(g_expert.numpy(), expert)
    np.testing.assert_array_equal(g_keep.numpy(), keep)
    np.testing.assert_array_equal(g_expert.numpy()[keep], slot_e[keep])
    np.testing.assert_array_equal(g_pos.numpy()[keep], slot_c[keep])


@pytest.mark.parametrize("case", DROP_CASES)
def test_dropped_tokens_are_the_references_and_exact_zeros(case):
    t, d, f, e, cf, seed = case
    x, p = _inputs(t, d, f, e, seed)
    cfg = _cfg(t, d, f, e, cf)
    want_y, _ = _ref(x, p, cfg)
    got_y, _ = port.moe_ffn(_torch(p), torch.tensor(x),
                            port.MoEConfig(*cfg))
    _, _, _, keep, _ = _ref_routing(x, p, cfg)
    assert (~keep).sum() > 0
    got_zero = (got_y.numpy() == 0).all(axis=1)
    want_zero = (want_y == 0).all(axis=1)
    np.testing.assert_array_equal(got_zero, ~keep)
    np.testing.assert_array_equal(want_zero, ~keep)
    # at most E * C tokens are served
    assert keep.sum() <= e * port._capacity(t, e, cf)


@pytest.mark.parametrize("case", CASES[1:3] + DROP_CASES[:2])
def test_gradients_equal_jax_grad(case):
    """d(sum(y * w) + aux) with respect to x and all five params: the
    router's through the gates and the aux loss."""
    t, d, f, e, cf, seed = case
    x, p = _inputs(t, d, f, e, seed)
    w = np.random.default_rng(seed + 100).standard_normal(
        (t, d)).astype(np.float32)
    cfg = _cfg(t, d, f, e, cf)

    def objective(params, xx):
        y, aux = ref.moe_ffn(params, xx, ref.MoEConfig(*cfg))
        return jnp.sum(y * jnp.asarray(w)) + aux

    g_p, g_x = jax.grad(objective, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _torch(p).items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = port.moe_ffn(tp, tx, port.MoEConfig(*cfg))
    ((y * torch.tensor(w)).sum() + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_x), rtol=0,
                               atol=GRAD_ATOL)
    for k in PARAMS:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g_p[k]),
                                   rtol=0, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], DROP_CASES[0],
                                  DROP_CASES[2]])
def test_index_form_equals_onehot_form(case):
    """The index form and the literal one-hot form on the same inputs:
    the same values (each one-hot sum has one nonzero term) and the same
    gradients."""
    t, d, f, e, cf, seed = case
    x, p = _inputs(t, d, f, e, seed)
    cfg = port.MoEConfig(*_cfg(t, d, f, e, cf))
    w = torch.tensor(np.random.default_rng(seed + 100).standard_normal(
        (t, d)).astype(np.float32))
    outs = []
    for fn in (port.moe_ffn, port.moe_ffn_onehot):
        tp = {k: v.requires_grad_() for k, v in _torch(p).items()}
        tx = torch.tensor(x, requires_grad=True)
        y, aux = fn(tp, tx, cfg)
        ((y * w).sum() + aux).backward()
        outs.append((y.detach(), aux.detach(), tx.grad,
                     {k: tp[k].grad for k in PARAMS}))
    (y1, a1, gx1, gp1), (y2, a2, gx2, gp2) = outs
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=0, atol=ATOL)
    assert abs(float(a1 - a2)) <= ATOL
    np.testing.assert_allclose(gx1.numpy(), gx2.numpy(), rtol=0,
                               atol=GRAD_ATOL)
    for k in PARAMS:
        np.testing.assert_allclose(gp1[k].numpy(), gp2[k].numpy(), rtol=0,
                                   atol=GRAD_ATOL, err_msg=k)


def test_ties_route_to_the_first_expert_as_jnp_argmax():
    """A zero router gives every expert the same probability: both
    packages send every token to expert 0, in token order."""
    t, e = 20, 4
    x = np.random.default_rng(7).standard_normal((t, 8)).astype(np.float32)
    router = np.zeros((8, e), np.float32)
    cap = port._capacity(t, e, 2.0)
    expert, pos, gate, keep, aux = port.route(
        torch.tensor(x), torch.tensor(router), e, cap)
    assert expert.tolist() == [0] * t
    assert pos.tolist() == list(range(t))
    assert keep.tolist() == [i < cap for i in range(t)]
    assert torch.allclose(gate, torch.full((t,), 1 / e))
    dispatch, _, ref_aux = ref._route(jnp.asarray(x), jnp.asarray(router),
                                      e, cap)
    assert np.asarray(dispatch)[:, 0].sum() == cap
    assert abs(float(aux) - float(ref_aux)) <= ATOL


def test_aux_punishes_a_collapsed_router():
    """The reference's own property: every token on one expert scores
    aux = E, more than a spread router."""
    cfg = port.MoEConfig(n_experts=4, d_model=8, d_ff=16)
    params = port.init_moe_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    x = torch.tensor(np.abs(np.random.default_rng(3).standard_normal(
        (64, 8))).astype(np.float32) + 0.1)
    collapsed = dict(params, router=torch.zeros(8, 4).index_fill_(
        1, torch.tensor([0]), 10.0))
    _, aux_col = port.moe_ffn(collapsed, x, cfg)
    _, aux_spread = port.moe_ffn(params, x, cfg)
    assert float(aux_col) > float(aux_spread)
    assert float(aux_col) == pytest.approx(cfg.n_experts, rel=1e-3)
    _, none = port.moe_ffn(params, x, cfg, with_aux=False)
    assert none is None


@pytest.mark.parametrize("d, f", [(64, 128), (128, 256)])
def test_init_draws_the_references_distributions(d, f):
    cfg = port.MoEConfig(n_experts=4, d_model=d, d_ff=f)
    params = port.init_moe_params(cfg, torch.Generator().manual_seed(1),
                                  "cpu")
    assert params["router"].shape == (d, 4)
    assert params["w_in"].shape == (4, d, f)
    assert params["w_out"].shape == (4, f, d)
    for k, std in (("router", d ** -0.5), ("w_in", d ** -0.5),
                   ("w_out", f ** -0.5)):
        assert abs(float(params[k].std()) - std) < 0.1 * std, k
    # plain normal, not truncated: draws beyond two standard deviations
    assert float(params["w_in"].abs().max()) > 2.5 * d ** -0.5
    assert not params["b_in"].any() and not params["b_out"].any()
    again = port.init_moe_params(cfg, torch.Generator().manual_seed(1),
                                 "cpu")
    assert all(torch.equal(params[k], again[k]) for k in PARAMS)
    ref_params = ref.init_moe_params(jax.random.PRNGKey(1),
                                     ref.MoEConfig(4, d, f))
    assert {k: tuple(v.shape) for k, v in ref_params.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
