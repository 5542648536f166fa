"""The sequence template (SASRec) in the PyTorch port against the JAX
package, on the CPU.

Both packages build the same sequences from the same events; from the
reference's initial params (carried across by
``convert.sequence_params_from_numpy``) the port's encoder gives the same
logits under every attention, and N Adam steps on the same batch stream
give the same loss, also when the port's run is stopped and resumed from
a step checkpoint; a model trained by the reference and carried across
serves the same items. Then the port's own paths: ``max_len``
adaptation, blackList, unknown users, live history through
``EventStore.find_by_entity`` on sqlite, the train and deploy verbs with
``--device cpu``, and the parts not ported yet, which raise. The
mixture-of-experts blocks (``moe_experts > 0``) are held to the reference
the same way: logits, Adam steps, a resumed run, and a reference-trained
model served at a capacity that keeps every token and at one that drops
some.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import dataclasses
import json
import os
import subprocess
import sys
import types
import urllib.request
from datetime import datetime, timedelta, timezone
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.data.eventstore import EventStore as RefEventStore
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.models import sequence as ref
from pio_tpu.ops import attention as ref_attn
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.convert import (
    sequence_model_from_numpy,
    sequence_params_from_numpy,
)
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.eventstore import EventStore
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import sequence as port
from pio_tpu_torch.ops import attention as port_attn
from pio_tpu_torch.workflow.checkpoint import models_from_bytes, models_to_bytes
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.train import load_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORY = "pio_tpu_torch.models.sequence.SequenceEngine"
APP = "SeqApp"
# logits from the same params: f32 sums in other orders (measured ~3e-7)
LOGITS_ATOL = 1e-5
# the loss after N Adam steps from the same params and batches: rounding
# of the two frameworks' kernels, carried through Adam (measured ~5e-7
# relative after 50 steps)
LOSS_RTOL = 1e-5
# logits of the params after 20 Adam steps from the same init and
# batches: Adam's normalized update carries the two frameworks' f32
# gradient rounding into the params, so the logits drift past LOGITS_ATOL
# (which holds at the same params); measured max 1.19e-5 over 18,600
TRAINED_LOGITS_ATOL = 3e-5
# served scores of the same model: the same f32 forward, summed in other
# orders; ids are compared wherever neighbouring scores differ by more
SCORE_ATOL = 1e-5
SMALL = dict(max_len=16, embed_dim=32, num_heads=2, num_layers=2,
             ffn_dim=64, batch_size=16)
MOE = dict(moe_experts=4)
# the loss after N Adam steps with experts, from the same params and
# batches. Top-1 routing is discontinuous: after some steps a token whose
# two largest router probabilities nearly tie can go to the other expert
# on f32 rounding alone. On these inputs the reference's own "reference"
# and "chunked" attentions part so at step 15 (losses 2.4e-5 relative
# apart); the port's loss sits within 2.5e-5 of the reference's at every
# step measured (1-20), and within 2.1e-7 where no token flips. The
# weighted aux loss alone is ~3e-3 of the loss, so an error there shows.
MOE_LOSS_RTOL = 1e-4
# a capacity factor at which a batch of 5 histories (bucket 8 x 15
# positions = 120 tokens, 8 slots an expert) drops tokens
MOE_LOW_CF = 0.25
# what train and prepare_model_for_deploy read of a context
_CPU_CTX = types.SimpleNamespace(device=torch.device("cpu"),
                                 event_store=None)


class _Ev:
    def __init__(self, u, i, t):
        self.entity_id = u
        self.target_entity_id = i
        self.event_time = t


def _cyclic_events(n_users=40, steps=8, n_items=12):
    """The reference tests' learnable pattern: user u walks the item
    cycle from u % 3."""
    return [_Ev(f"u{u}", f"i{(u % 3 + t) % n_items}", t)
            for u in range(n_users) for t in range(steps)]


def _random_events(seed=0, n_users=40, n_items=30):
    rng = np.random.default_rng(seed)
    return [_Ev(f"u{u}", f"i{int(rng.integers(0, n_items))}",
                int(rng.integers(0, 5)))    # time ties: order must hold
            for u in range(n_users) for _ in range(int(rng.integers(1, 20)))]


def _port_params(p):
    return port.SequenceParams(**dataclasses.asdict(p))


def _ref_init(n_items, p):
    """The reference's initial params, drawn as its trainer draws them."""
    enc = ref.make_encoder(n_items, p)
    return jax.device_get(enc.init(
        jax.random.PRNGKey(p.seed), jnp.zeros((1, p.max_len - 1), jnp.int32),
        partial(ref_attn.attention_reference, causal=True))["params"])


@pytest.mark.parametrize("events", [_cyclic_events, _random_events])
def test_sequences_and_histories_equal_reference(events):
    evs = events()
    for max_len in (4, 16):
        got = port.build_sequences(evs, max_len)
        want = ref.build_sequences(evs, max_len)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype
        assert got[1].ids() == want[1].ids()
        assert got[2].ids() == want[2].ids()
    h_got, i_got = port.user_histories(evs)
    h_want, i_want = ref.user_histories(evs)
    assert h_got == h_want and i_got.ids() == i_want.ids()
    with pytest.raises(ValueError, match=">= 2 interactions"):
        port.build_sequences([_Ev("solo", "a", 1)], 4)


@pytest.mark.parametrize("attention", ["reference", "chunked", "flash"])
def test_logits_from_reference_params_equal_reference(attention):
    seqs, users, items = ref.build_sequences(_random_events(), 16)
    p = ref.SequenceParams(**SMALL)
    init = _ref_init(len(items), p)
    fns = {"reference": (ref_attn.attention_reference,
                         port_attn.attention_reference),
           "chunked": (ref_attn.chunked_attention,
                       port_attn.chunked_attention),
           "flash": (ref_attn.flash_attention, port_attn.flash_attention)}
    ref_fn, port_fn = fns[attention]
    inp = seqs[:, :-1]
    x_want, want = ref.make_encoder(len(items), p).apply(
        {"params": init}, jnp.asarray(inp), partial(ref_fn, causal=True))
    enc = port.make_encoder(len(items), _port_params(p))
    enc.load_state_dict(sequence_params_from_numpy(init, device="cpu"))
    with torch.no_grad():
        x_got, got = enc(torch.from_numpy(inp).long(),
                         partial(port_fn, causal=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGITS_ATOL)
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), rtol=0,
                               atol=LOGITS_ATOL)


@pytest.mark.parametrize("attention, steps", [
    ("reference", 1), ("reference", 20), ("chunked", 20), ("flash", 20),
    ("auto", 20), ("auto", 0)])
def test_adam_steps_give_reference_loss(attention, steps):
    seqs, users, items = ref.build_sequences(_random_events(), 16)
    p = ref.SequenceParams(**SMALL, steps=steps, attention=attention)
    _, _, want = ref.train_sequence_model(ref.SequenceData(seqs, users,
                                                           items), p)
    init = sequence_params_from_numpy(_ref_init(len(items), p),
                                      device="cpu")
    params, _, got = port.train_sequence_model(
        port.SequenceData(seqs, users, items), _port_params(p),
        device="cpu", init=init)
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    assert set(params) == set(init)


@pytest.mark.parametrize("stop_at", [6, 11, 20])
def test_resumed_run_gives_reference_loss_and_logits(tmp_path, stop_at):
    """The port's run from the reference's initial params, stopped after
    ``stop_at`` steps (a step checkpoint every 5) and resumed in a new
    trainer, ends with the params of the port's uninterrupted run, bit
    for bit, and where the reference's uninterrupted run does: the same
    final loss (LOSS_RTOL) and logits from the final params within
    TRAINED_LOGITS_ATOL."""
    from pio_tpu_torch.workflow.step_checkpoint import (
        StepCheckpointConfig,
        StepCheckpointer,
    )

    seqs, users, items = ref.build_sequences(_random_events(), 16)
    p = ref.SequenceParams(**SMALL, steps=20, attention="reference")
    want_params, _, want = ref.train_sequence_model(
        ref.SequenceData(seqs, users, items), p)
    init = sequence_params_from_numpy(_ref_init(len(items), p),
                                      device="cpu")
    data = port.SequenceData(seqs, users, items)

    def ckpt():
        return StepCheckpointer(StepCheckpointConfig(str(tmp_path / "ck"),
                                                     save_every=5))

    whole, _, whole_loss = port.train_sequence_model(
        data, _port_params(p), device="cpu", init=init)
    port.train_sequence_model(data, _port_params(
        dataclasses.replace(p, steps=stop_at)), device="cpu", init=init,
        checkpoint=ckpt())
    params, enc, got = port.train_sequence_model(
        data, _port_params(p), device="cpu", checkpoint=ckpt())
    assert got == whole_loss
    for k, v in whole.items():
        assert torch.equal(params[k], v), k
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    inp = seqs[:, :-1]
    _, logits_want = ref.make_encoder(len(items), p).apply(
        {"params": want_params}, jnp.asarray(inp),
        partial(ref_attn.attention_reference, causal=True))
    with torch.no_grad():
        _, logits_got = enc(torch.from_numpy(inp).long(),
                            partial(port_attn.attention_reference,
                                    causal=True))
    np.testing.assert_allclose(logits_got.numpy(), np.asarray(logits_want),
                               rtol=0, atol=TRAINED_LOGITS_ATOL)


def test_seeded_init_draws_flax_distributions():
    p = port.SequenceParams(embed_dim=64, num_heads=2, num_layers=1,
                            ffn_dim=256)
    enc = port.init_encoder_(port.make_encoder(4000, p), seed=3)
    assert abs(float(enc.item_emb.detach().std()) - 0.02) < 1e-3
    w = enc.blocks[0].ffn_in.weight.detach()  # (256, 64): fan_in 64
    assert abs(float(w.std()) - 64 ** -0.5) < 0.05 * 64 ** -0.5
    assert float(w.abs().max()) <= 2 * 64 ** -0.5 / .87962566103423978
    assert bool((enc.blocks[0].ffn_in.bias == 0).all())
    assert bool((enc.ln_f.weight == 1).all())
    again = port.init_encoder_(port.make_encoder(4000, p), seed=3)
    assert torch.equal(enc.item_emb, again.item_emb)


@pytest.fixture(scope="module")
def carried():
    """A model trained by the reference on the cyclic pattern, and the
    same model carried across into the port."""
    seqs, users, items = ref.build_sequences(_cyclic_events(), 16)
    p = ref.SequenceParams(**{**SMALL, "batch_size": 32}, steps=150)
    params, _, _ = ref.train_sequence_model(
        ref.SequenceData(seqs, users, items), p)
    want = ref.SequenceModel(params=params, seqs=seqs, users=users,
                             items=items, config=p)
    got = sequence_model_from_numpy(
        jax.device_get(params), seqs, users.ids(), items.ids(),
        _port_params(p), device="cpu")
    return want, got


def _assert_same_ranking(got, want):
    gi = [s["item"] for s in got["itemScores"]]
    wi = [s["item"] for s in want["itemScores"]]
    gs = [s["score"] for s in got["itemScores"]]
    ws = [s["score"] for s in want["itemScores"]]
    assert len(gi) == len(wi)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_ATOL)
    for i, (a, b) in enumerate(zip(gi, wi)):
        gaps = [abs(ws[i] - ws[j]) for j in (i - 1, i + 1)
                if 0 <= j < len(ws)]
        if a != b:
            assert min(gaps) <= 2 * SCORE_ATOL, (i, got, want)


def test_batch_predict_serves_reference_items(carried):
    want_model, got_model = carried
    queries = [{"user": u, "num": 5} for u in want_model.users.ids()[:12]]
    queries += [{"user": "u1", "num": 4, "blackList": ["i9", "nope"]},
                {"user": "ghost", "num": 3}, {"user": "u2", "num": 30}]
    want = ref.SequenceAlgorithm(want_model.config).batch_predict(
        want_model, queries)
    algo = port.SequenceAlgorithm(got_model.config)
    got = algo.batch_predict(got_model, queries)
    for g, w in zip(got, want):
        _assert_same_ranking(g, w)
    for q, g in zip(queries, got):
        _assert_same_ranking(algo.predict(got_model, q), g)
    # the learned cycle: u0 saw i0..i7, so i8 comes next
    assert got[0]["itemScores"][0]["item"] == "i8"
    assert all(s["item"] not in ("i9", "nope")
               for s in got[-3]["itemScores"])
    assert got[-2] == {"itemScores": []}
    # unseen_only: the 8 items of u2's history are not served
    assert len(got[-1]["itemScores"]) == len(got_model.items) - 8


def test_model_round_trips_through_the_model_blob(carried):
    _, model = carried
    [back] = models_from_bytes(models_to_bytes([model]))
    assert isinstance(back.params["item_emb"], np.ndarray)
    algo = port.SequenceAlgorithm(model.config)
    ready = algo.prepare_model_for_deploy(_CPU_CTX, back)
    assert ready.params["item_emb"].device.type == "cpu"
    q = {"user": "u4", "num": 6}
    assert algo.predict(ready, q) == algo.predict(model, q)


def test_train_adapts_datasource_max_len():
    seqs, users, items = port.build_sequences(_cyclic_events(), 64)
    p = port.SequenceParams(max_len=16, embed_dim=16, num_heads=2,
                            num_layers=1, ffn_dim=32, steps=3,
                            batch_size=16)
    model = port.SequenceAlgorithm(p).train(
        _CPU_CTX, port.SequenceData(seqs, users, items))
    assert model.seqs.shape[1] == 16
    np.testing.assert_array_equal(model.seqs, seqs[:, -16:])
    seqs8, users8, items8 = port.build_sequences(_cyclic_events(), 8)
    model2 = port.SequenceAlgorithm(p).train(
        _CPU_CTX, port.SequenceData(seqs8, users8, items8))
    assert model2.seqs.shape[1] == 16
    np.testing.assert_array_equal(model2.seqs[:, 8:], seqs8)
    assert not model2.seqs[:, :8].any()


def test_checkpoint_dir_saves_and_a_second_train_resumes(tmp_path):
    """``checkpoint_dir`` in the params: the trainer saves every
    ``checkpoint_every`` steps (the newest three kept); training again on
    the same directory restores the final step and takes no step, so the
    params are the first run's."""
    seqs, users, items = port.build_sequences(_cyclic_events(), 8)
    p = port.SequenceParams(max_len=8, embed_dim=16, num_heads=2,
                            num_layers=1, ffn_dim=32, steps=9, batch_size=8,
                            checkpoint_dir=str(tmp_path / "ck"),
                            checkpoint_every=2)
    data = port.SequenceData(seqs, users, items)
    first = port.SequenceAlgorithm(p).train(_CPU_CTX, data)
    assert sorted(os.listdir(tmp_path / "ck"), key=int) == ["4", "6", "8"]
    again = port.SequenceAlgorithm(p).train(_CPU_CTX, data)
    for k, v in first.params.items():
        assert torch.equal(again.params[k], v), k


@pytest.mark.parametrize("change, error", [
    # the MoE FFN is ported: it trains on the CPU
    (dict(moe_experts=4), None),
    (dict(attention="ring"), ValueError),
    (dict(attention="ulysses"), ValueError),
    (dict(attention="linear"), ValueError),
])
def test_parts_not_ported_raise(change, error):
    seqs, users, items = port.build_sequences(_cyclic_events(), 8)
    p = port.SequenceParams(max_len=8, embed_dim=16, num_heads=2,
                            num_layers=1, ffn_dim=32, steps=2,
                            batch_size=8, **change)
    data = port.SequenceData(seqs, users, items)
    if error is None:
        params, _, loss = port.train_sequence_model(data, p, device="cpu")
        assert np.isfinite(loss)
        assert params["blocks.0.moe_w_in"].shape == (4, 16, 32)
        assert "blocks.0.ffn_in.weight" not in params
        return
    with pytest.raises(error):
        port.train_sequence_model(data, p, device="cpu")


def test_not_ported_reads_and_no_cuda_raise(monkeypatch):
    """The rolling evaluation folds are ported (held to the reference in
    test_torch_evaluation.py): fold f holds out each user's (f+1)-th
    item from the end. Training without CUDA still raises."""
    import types

    ctx = types.SimpleNamespace(event_store=types.SimpleNamespace(
        find=lambda **kw: _cyclic_events(n_users=4, steps=5)))
    folds = port.SequenceDataSource(port.SequenceDataSourceParams(
        eval_k=2, max_len=8)).read_eval(ctx)
    assert [info for _, info, _ in folds] == [{"fold": 0, "holdout": 1},
                                              {"fold": 1, "holdout": 2}]
    assert folds[0][2][0] == ({"user": "u0", "num": 10}, ["i4"])
    assert folds[1][2][0] == ({"user": "u0", "num": 10}, ["i3"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs, users, items = port.build_sequences(_cyclic_events(), 8)
    p = port.SequenceParams(max_len=8, embed_dim=16, num_heads=2,
                            num_layers=1, ffn_dim=32, steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.SequenceAlgorithm(p).train(
            None, port.SequenceData(seqs, users, items))


# -- the mixture-of-experts blocks ---------------------------------------------

@pytest.mark.parametrize("attention", ["reference", "chunked"])
def test_moe_logits_from_reference_params_equal_reference(attention):
    seqs, users, items = ref.build_sequences(_random_events(), 16)
    p = ref.SequenceParams(**SMALL, **MOE)
    init = _ref_init(len(items), p)
    assert "moe_router" in init["Block_0"]
    fns = {"reference": (ref_attn.attention_reference,
                         port_attn.attention_reference),
           "chunked": (ref_attn.chunked_attention,
                       port_attn.chunked_attention)}
    ref_fn, port_fn = fns[attention]
    inp = seqs[:, :-1]
    _, want = ref.make_encoder(len(items), p).apply(
        {"params": init}, jnp.asarray(inp), partial(ref_fn, causal=True))
    enc = port.make_encoder(len(items), _port_params(p))
    state = sequence_params_from_numpy(init, device="cpu")
    assert set(state) == set(enc.state_dict())
    enc.load_state_dict(state)
    with torch.no_grad():
        _, got = enc(torch.from_numpy(inp).long(),
                     partial(port_fn, causal=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGITS_ATOL)


@pytest.mark.parametrize("attention, steps, cf", [
    ("reference", 1, 2.0), ("reference", 20, 2.0), ("chunked", 20, 2.0),
    ("reference", 20, 0.5)])
def test_moe_adam_steps_give_reference_loss(attention, steps, cf):
    """The loss (cross-entropy plus the weighted aux loss) after N steps,
    also at a capacity that drops tokens in training."""
    seqs, users, items = ref.build_sequences(_random_events(), 16)
    p = ref.SequenceParams(**SMALL, **MOE, moe_capacity_factor=cf,
                           steps=steps, attention=attention)
    _, _, want = ref.train_sequence_model(ref.SequenceData(seqs, users,
                                                           items), p)
    init = sequence_params_from_numpy(_ref_init(len(items), p),
                                      device="cpu")
    params, _, got = port.train_sequence_model(
        port.SequenceData(seqs, users, items), _port_params(p),
        device="cpu", init=init)
    assert got == pytest.approx(want, rel=MOE_LOSS_RTOL)
    assert set(params) == set(init)


def test_moe_resumed_run_equals_the_uninterrupted_run(tmp_path):
    """Stopped after 7 steps (a step checkpoint every 3) and resumed in a
    new trainer: the uninterrupted run's params, bit for bit, and its
    loss."""
    from pio_tpu_torch.workflow.step_checkpoint import (
        StepCheckpointConfig,
        StepCheckpointer,
    )

    seqs, users, items = port.build_sequences(_random_events(), 16)
    p = port.SequenceParams(**SMALL, **MOE, steps=12)
    data = port.SequenceData(seqs, users, items)

    def ckpt():
        return StepCheckpointer(StepCheckpointConfig(str(tmp_path / "ck"),
                                                     save_every=3))

    whole, _, whole_loss = port.train_sequence_model(data, p, device="cpu")
    port.train_sequence_model(data, dataclasses.replace(p, steps=7),
                              device="cpu", checkpoint=ckpt())
    params, _, got = port.train_sequence_model(data, p, device="cpu",
                                               checkpoint=ckpt())
    assert got == whole_loss
    for k, v in whole.items():
        assert torch.equal(params[k], v), k


def test_moe_seeded_init_draws_the_references_distributions():
    p = port.SequenceParams(embed_dim=64, num_heads=2, num_layers=2,
                            ffn_dim=256, **MOE)
    enc = port.init_encoder_(port.make_encoder(4000, p), seed=3)
    for name, std in (("moe_router", 64 ** -0.5), ("moe_w_in", 64 ** -0.5),
                      ("moe_w_out", 256 ** -0.5)):
        # both blocks' draws: 512 router entries, a 4 % standard error
        w = torch.cat([getattr(b, name).detach().reshape(-1)
                       for b in enc.blocks])
        assert abs(float(w.std()) - std) < 0.12 * std, name
    for block in enc.blocks:
        assert not hasattr(block, "ffn_in")
        # plain normal: draws past the truncated normal's two std devs
        assert float(block.moe_w_in.detach().abs().max()) > 3 * 64 ** -0.5
        assert not block.moe_b_in.any() and not block.moe_b_out.any()
    assert enc.blocks[0].moe_router.shape == (64, 4)
    assert enc.blocks[0].moe_w_out.shape == (4, 256, 64)
    # the dense kernels keep their truncated lecun-normal
    w = enc.blocks[0].qkv.weight.detach()
    assert float(w.abs().max()) <= 2 * 64 ** -0.5 / .87962566103423978
    again = port.init_encoder_(port.make_encoder(4000, p), seed=3)
    assert torch.equal(enc.blocks[1].moe_w_out, again.blocks[1].moe_w_out)


@pytest.fixture(scope="module")
def carried_moe():
    """A MoE model trained by the reference on the cyclic pattern, and
    the same model carried across into the port."""
    seqs, users, items = ref.build_sequences(_cyclic_events(), 16)
    p = ref.SequenceParams(**{**SMALL, "batch_size": 32}, **MOE, steps=100)
    params, _, _ = ref.train_sequence_model(
        ref.SequenceData(seqs, users, items), p)
    params = jax.device_get(params)
    return seqs, users, items, p, params


@pytest.mark.parametrize("cf", [2.0, MOE_LOW_CF])
def test_moe_batch_predict_serves_reference_items(carried_moe, cf):
    """A batch of 5 (bucket 8) through both packages' batch_predict: the
    same items and scores, at a capacity that keeps every token and at one
    that drops tokens (where both packages count the bucket's PAD rows)."""
    seqs, users, items, p, params = carried_moe
    p = dataclasses.replace(p, moe_capacity_factor=cf)
    want_model = ref.SequenceModel(params=params, seqs=seqs, users=users,
                                   items=items, config=p)
    got_model = sequence_model_from_numpy(
        params, seqs, users.ids(), items.ids(), _port_params(p),
        device="cpu")
    queries = [{"user": u, "num": 5} for u in users.ids()[:5]]
    want = ref.SequenceAlgorithm(p).batch_predict(want_model, queries)
    got = port.SequenceAlgorithm(got_model.config).batch_predict(
        got_model, queries)
    for g, w in zip(got, want):
        assert g["itemScores"]
        _assert_same_ranking(g, w)
    if cf == 2.0:
        assert got[0]["itemScores"][0]["item"] == "i8"


# -- on sqlite: live history, the train and deploy verbs ---------------------

def _storage_env(tmp_path):
    return {"PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(tmp_path / "pio.db"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"}


T0 = datetime(2024, 1, 1, tzinfo=timezone.utc)


def _write_cyclic(storage, n_users=30, steps=8, start=0):
    """view/buy events of the cyclic pattern, one second apart, plus
    `rate` events the data source must skip."""
    apps = storage.get_metadata_apps()
    app = apps.get_by_name(APP)
    app_id = app.id if app else apps.insert(App(0, APP))
    events = storage.get_events()
    events.init(app_id)
    batch = []
    for u in range(n_users):
        for t in range(steps):
            batch.append(Event(
                "buy" if t % 3 == 2 else "view", "user", f"u{u}", "item",
                f"i{(u % 3 + t) % 12}", {},
                T0 + timedelta(seconds=start + u * steps + t)))
        batch.append(Event("rate", "user", f"u{u}", "item", "i11",
                           {"rating": 5.0}, T0 + timedelta(days=1)))
    events.insert_batch(batch, app_id)
    return app_id


def test_live_history_reads_the_event_store(tmp_path, carried):
    """With app_name set, serving scores the user's newest events from
    sqlite (through find_by_entity), including a user unseen in training
    and events written after it; the reference does the same on the same
    database."""
    want_model, got_model = carried
    env = _storage_env(tmp_path)
    storage = Storage(env=env)
    app_id = _write_cyclic(storage, n_users=3)
    # after training: a fresh user walks i3..i7, u0 moves on to i8, i9
    storage.get_events().insert_batch(
        [Event("view", "user", "fresh", "item", f"i{t}", {},
               T0 + timedelta(days=2, seconds=t)) for t in range(3, 8)]
        + [Event("view", "user", "u0", "item", f"i{t}", {},
                 T0 + timedelta(days=2, seconds=t)) for t in (8, 9)],
        app_id)
    cfg = dataclasses.replace(got_model.config, app_name=APP)
    ref_cfg = dataclasses.replace(want_model.config, app_name=APP)
    algo = port.SequenceAlgorithm(cfg)
    model = algo.prepare_model_for_deploy(
        create_workflow_context(storage, device="cpu"),
        dataclasses.replace(got_model, config=cfg))
    ref_storage = RefStorage(env=env)
    ref_algo = ref.SequenceAlgorithm(ref_cfg)
    ref_algo._event_store = RefEventStore(ref_storage)
    ref_model = dataclasses.replace(want_model, config=ref_cfg)
    try:
        queries = [{"user": "fresh", "num": 3}, {"user": "u0", "num": 3},
                   {"user": "u1", "num": 3}, {"user": "ghost", "num": 3}]
        got = algo.batch_predict(model, queries)
        want = ref_algo.batch_predict(ref_model, queries)
        rows = [algo.history_row(model, q) for q in queries]
    finally:
        storage.close()
        ref_storage.close()
    for g, w in zip(got, want):
        _assert_same_ranking(g, w)
    assert got[0]["itemScores"][0]["item"] == "i8"   # i3..i7 -> i8
    assert got[3] == {"itemScores": []}
    assert rows[3] is None

    def history(row):
        return [model.items.decode([i - 1])[0] for i in row if i]

    assert history(rows[0]) == [f"i{t}" for t in range(3, 8)]
    assert history(rows[1]) == [f"i{t}" for t in range(10)]
    # u1 has no later events: its live history is its training row
    np.testing.assert_array_equal(rows[2], model.seqs[
        model.users.index_of("u1")])


def _variant(**algo):
    return {"id": "seq", "engineFactory": FACTORY,
            "datasource": {"params": {"app_name": APP, "max_len": 16}},
            "algorithms": [{"name": "sasrec", "params": {
                **SMALL, "steps": 40, "seed": 5, **algo}}]}


def _post(port_no, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port_no}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_train_then_deploy_on_cpu(tmp_path, monkeypatch):
    """`train --device cpu` reads the reference's sequences from sqlite
    and stores the model its own trainer gives; `deploy --device cpu`, a
    real process, answers /queries.json and /batch/queries.json as the
    loaded model does in process."""
    _train_then_deploy(tmp_path, monkeypatch)


def test_moe_train_then_deploy_on_cpu(tmp_path, monkeypatch):
    """The same with four experts in every block: trained by the verb
    (a step checkpoint saved on the way), stored, deployed and served."""
    _train_then_deploy(tmp_path, monkeypatch, **MOE, checkpoint_every=10)
    assert sorted(os.listdir(tmp_path / "ckpt"))


def _train_then_deploy(tmp_path, monkeypatch, **algo):
    env = _storage_env(tmp_path)
    storage = Storage(env=env)
    _write_cyclic(storage)
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps(_variant(**algo)))
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    ref_storage = RefStorage(env=env)
    try:
        assert port_main(["train", "--engine-dir", str(engine_dir),
                          "--device", "cpu"]) == 0
        inst = storage.get_metadata_engine_instances() \
            .get_latest_completed("seq", "1", "default")
        engine = port.SequenceEngine.apply()
        ep = engine.engine_params_from_variant(_variant(**algo))
        ctx = create_workflow_context(storage, device="cpu")
        [model] = load_models(storage, engine, ep, inst.id, ctx)
        data = port.SequenceDataSource(ep.datasource[1]).read_training(ctx)
        ref_ds = ref.SequenceDataSource(ref.SequenceDataSourceParams(
            app_name=APP, max_len=16))
        want_data = ref_ds.read_training(type(
            "Ctx", (), {"event_store": RefEventStore(ref_storage)})())
    finally:
        storage.close()
        ref_storage.close()
    np.testing.assert_array_equal(data.seqs, want_data.seqs)
    assert data.users.ids() == want_data.users.ids()
    np.testing.assert_array_equal(model.seqs, data.seqs)
    params, _, _ = port.train_sequence_model(
        data, ep.algorithms[0][1], device="cpu")
    for k, v in params.items():
        assert torch.equal(model.params[k], v), k

    algo = port.SequenceAlgorithm(ep.algorithms[0][1])
    queries = [{"user": "u0", "num": 3},
               {"user": "u4", "num": 5, "blackList": ["i0"]},
               {"user": "nobody", "num": 3}]
    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch", "deploy", "--engine-dir",
         str(engine_dir), "--device", "cpu", "--port", "0",
         "--ip", "127.0.0.1"],
        cwd=REPO, env={**os.environ, **env}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert f"Engine instance {inst.id} deployed" in line, (
            line + proc.stderr.read() if proc.poll() is not None else line)
        port_no = int(line.split("127.0.0.1:")[1].split()[0])
        for q in queries:
            status, body = _post(port_no, "/queries.json", q)
            assert status == 200
            _assert_same_ranking(body, algo.predict(model, q))
        status, body = _post(port_no, "/batch/queries.json", queries)
        assert status == 200
        for got, want in zip(body, algo.batch_predict(model, queries)):
            _assert_same_ranking(got, want)
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    # u4 walked i1..i8: of the 10 items, i9 is left once i0 is blacklisted
    assert [s["item"] for s in body[1]["itemScores"]] == ["i9"]
    assert body[2] == {"itemScores": []}


def test_deployed_server_reads_live_history(tmp_path, carried):
    """The algorithm that serves is the one deploy prep bound the event
    store to, so a deployed engine with app_name set answers a user known
    only from events written after training."""
    from pio_tpu_torch.workflow.serve import QueryServer, ServingConfig
    from pio_tpu_torch.workflow.train import persist_models

    _, model = carried
    cfg = dataclasses.replace(model.config, app_name=APP)
    variant = {"id": "seq-live", "engineFactory": FACTORY,
               "datasource": {"params": {"app_name": APP}},
               "algorithms": [{"name": "sasrec",
                               "params": dataclasses.asdict(cfg)}]}
    engine = port.SequenceEngine.apply()
    ep = engine.engine_params_from_variant(variant)
    storage = Storage(env=_storage_env(tmp_path))
    try:
        app_id = _write_cyclic(storage, n_users=1)
        persist_models([dataclasses.replace(model, config=cfg)], ep, storage,
                       "seq-live")
        qs = QueryServer(engine, ep, storage,
                         ServingConfig(engine_id="seq-live"),
                         ctx=create_workflow_context(storage, device="cpu"))
        assert qs.query({"user": "fresh", "num": 3}) == {"itemScores": []}
        storage.get_events().insert_batch(
            [Event("view", "user", "fresh", "item", f"i{t}", {},
                   T0 + timedelta(days=2, seconds=t)) for t in range(3, 8)],
            app_id)
        got = qs.query({"user": "fresh", "num": 3})
    finally:
        storage.close()
    assert got["itemScores"][0]["item"] == "i8"
