"""Constrained beam search in aladin_torch (tasks/cbs.py) against
aladin_tpu's: the FSM tables, the adjacency conversion, the constraint
count, the constraint filter and the final selection bit for bit (the host
parts are copies), and the state-partitioned search on the device: tokens
and finished flags equal, scores within 1e-5, with the captioners of
tests/test_torch_captioning.py (aladin_tpu's weights carried across).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aladin_tpu.tasks import cbs as jcbs
from aladin_torch.tasks import cbs
from tests.test_torch_captioning import (ATOL, B, KW, VOCAB, _close, _t,  # noqa: F401
                                         captioner_pair, decode_case, one_torch_thread)

V = len(VOCAB)
FORMS = {
    "single": [[[3]], [[5], [6]]],
    "chain": [[[3, 4]]],
    "shared_prefix": [[[3]], [[3, 4]]],
    "chain_final_single": [[[4]], [[3, 4]]],
    "three": [[[7]], [[8, 9]], [[10], [11, 12]]],
}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_fsm_tables_equal_jax(name):
    got = cbs.FiniteStateMachineBuilder(V).build(FORMS[name])
    want = jcbs.FiniteStateMachineBuilder(V).build(FORMS[name])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype and got[1] == want[1]


def test_adjacency_and_constraint_count_equal_jax():
    rng = np.random.RandomState(0)
    fsm = rng.rand(5, 5, V) < 0.15
    np.testing.assert_array_equal(cbs.adjacency_to_next_state(fsm),
                                  jcbs.adjacency_to_next_state(fsm))
    states = np.arange(10)
    for c in (1, 2, 3):
        np.testing.assert_array_equal(cbs.num_constraints_satisfied(states, c),
                                      jcbs.num_constraints_satisfied(states, c))


def test_constraint_filter_equal_jax():
    rng = np.random.RandomState(1)
    boxes = rng.rand(8, 4).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    boxes[3] = boxes[1] + 0.01  # overlapping boxes: NMS
    names = ["dog", "animal", "background", "cat", "Tree", "dog", "thing", "car"]
    scores = rng.rand(8).astype(np.float32)
    hier = {"dog": "animal"}
    for max_given in (2, 3):
        got = cbs.ConstraintFilter(hier, 0.5, max_given)(boxes, names, scores)
        want = jcbs.ConstraintFilter(hier, 0.5, max_given)(boxes, names, scores)
        assert got == want


def _tables(names):
    tables = [cbs.FiniteStateMachineBuilder(V).build(FORMS[n])[0] for n in names]
    s = max(t.shape[0] for t in tables)
    pad = [np.concatenate([t, np.tile(np.arange(t.shape[0], s, dtype=np.int32)[:, None], (1, V))])
           for t in tables]
    return np.stack(pad), s


@pytest.mark.parametrize("beams", [2, 3])
def test_cbs_decode_matches_jax(beams):
    """Per-example FSM tables of other sizes (padded with identity rows):
    tokens (B, S, K, L) and finished equal, scores within 1e-5 (the -inf
    candidates clamped to -1e9 in both); the selected beams equal."""
    jm, params, tm = captioner_pair()
    inp = decode_case()
    nxt, s = _tables(["single", "chain", "shared_prefix"][:B])
    got = cbs.cbs_decode(tm, *_t(*inp), torch.from_numpy(nxt), num_beams=beams, num_states=s,
                         **KW)
    want = jcbs.cbs_decode(jm, params, *inp, jnp.asarray(nxt), num_beams=beams, num_states=s,
                           **KW)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1], atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    n_cons = np.array([2, 1, 2])
    for need in (1, 2):
        sel = cbs.select_best_beam_with_constraints(got[0].numpy(), got[1].numpy(), n_cons, need)
        jsel = jcbs.select_best_beam_with_constraints(np.asarray(want[0]), np.asarray(want[1]),
                                                      n_cons, need)
        np.testing.assert_array_equal(sel[0], jsel[0])
        _close(sel[1], jsel[1], atol=ATOL)


def test_select_best_beam_with_constraints_equal_jax():
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, V, (3, 8, 2, 6)).astype(np.int32)
    scores = (rng.randn(3, 8, 2) * 3).astype(np.float32)
    scores[1, 1:] = -1e9
    for n_cons, need in ((np.array([3, 1, 0]), 2), (np.array([2, 2, 3]), 1)):
        got = cbs.select_best_beam_with_constraints(tokens, scores, n_cons, need)
        want = jcbs.select_best_beam_with_constraints(tokens, scores, n_cons, need)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
