"""A run on the CPU with the timed path broken underneath: ``correct`` has
to come out false for each fault a cell can have, and true for the sound
program. (The cells use one chip, so no exchange between chips can be left
out.) The faults are planted in the program through the run's hook."""
import numpy as np
import pytest
import torch

from benchlib import inputs, runner


def _unchanged_state(prog):
    """A training step that returns its state unchanged."""
    serve = prog.tp.models.make_train_step(prog.model, train=False)

    def step(state, batch):
        _, loss, preds = serve(state, batch)
        return state, loss, preds
    prog.step = step


def _half_batch(prog):
    """Half of the batch left out, the mean taken over the rest."""
    loss = prog.model.loss

    def half(preds, labels):
        n = preds.shape[0] // 2
        return loss(preds[:n], labels[:n])
    prog.model.loss = half


def _altered_answer(prog):
    """One prediction of each request altered where it is produced."""
    step = prog.step

    def altered(state, batch):
        state, loss, preds = step(state, batch)
        preds = preds.clone()
        preds[7] += 0.5
        return state, loss, preds
    prog.step = altered


def _half_answers(prog):
    """A request that answers half of its candidates."""
    step = prog.step

    def half(state, batch):
        state, loss, preds = step(state, batch)
        preds = preds.clone()
        preds[preds.shape[0] // 2:] = 0.0
        return state, loss, preds
    prog.step = half


TRAIN = ["dcn_criteo.train_zipf", "bst_taobao.train_zipf"]
SERVE = ["dcn_criteo.serve_zipf", "bst_taobao.serve_zipf"]
CASES = ([(c, None, True, "") for c in TRAIN + SERVE]
         + [(c, f, False, "") for c in TRAIN
            for f in (_unchanged_state, _half_batch)]
         + [(c, f, False, "") for c in SERVE
            for f in (_altered_answer, _half_answers)]
         # the training cells again with plain SGD on tables and towers
         + [(c, f, f is None, "sgd-") for c in TRAIN
            for f in (None, _unchanged_state, _half_batch)])


@pytest.mark.parametrize("cell,fault,correct,rules", CASES,
                         ids=[f"{c}-{r}{f.__name__ if f else 'sound'}"
                              for c, f, _, r in CASES])
def test_correct_comes_out_false_for_each_fault(request, cell, fault,
                                                correct, rules):
    files, cells = request.getfixturevalue("tiny_sgd" if rules else "tiny")
    out = runner.run(files, cells[cell], 2 ** 31 + 99, 0.2,
                     False, "cpu", 0.0, hooks=fault)
    assert out["correct"] is correct, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    values = [c["value"] for c in out["checks"].values()]
    assert all(np.isfinite(values)) or not correct


def test_a_table_that_loses_an_inserted_id_is_not_correct(tiny):
    """An id inserted by the first step and gone afterwards counts as
    missing, which the limit 0 holds exactly."""
    files, cells = tiny

    def lose(prog):
        step = prog.step

        def forgetful(state, batch):
            state, loss, preds = step(state, batch)
            if int(state.step) == 1:
                first = torch.from_numpy(np.asarray(batch["ids"]["C1"][:1]))
                prog.tp.kv.delete(state.tables["C1"], inputs.encode(first))
            return state, loss, preds
        prog.step = forgetful

    out = runner.run(files, cells["dcn_criteo.train_zipf"], 2 ** 31 + 5, 0.2,
                     False, "cpu", 0.0, hooks=lose)
    assert out["checks"]["missing"]["value"] >= 1
    assert out["correct"] is False
