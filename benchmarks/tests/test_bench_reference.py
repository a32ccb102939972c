"""The plain references at tiny sizes against values worked out by hand,
and their independence from the program."""
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from reference import bst, dcn, sparse

from conftest import BENCH


def test_dcn_forward_by_hand():
    cfg = {"embedding_dims": [1, 1], "dnn_hidden": [1], "cross_layers": 1}
    t = torch.tensor
    p = {"dnn.0.w": t([[1.0], [2.0], [-1.0]]), "dnn.0.b": t([0.5]),
         "dnn_logits.w": t([[3.0]]), "dnn_logits.b": t([0.25]),
         "cross.0.w": t([1.0, 0.0, 2.0]), "cross.0.b": t([0.1, 0.2, 0.3]),
         "cross_logits.w": t([[1.0], [1.0], [1.0]]),
         "cross_logits.b": t([-1.0])}
    embs = {"C1": t([[1.0], [0.0]]), "C2": t([[2.0], [1.0]])}
    feats = t([[3.0], [4.0]])
    # example 0: x0 = [1, 2, 3]; deep relu(1 + 4 - 3 + .5) = 2.5 -> 7.75;
    # x0·w = 1 + 6 = 7; x1 = 7·x0 + b + x0 = [8.1, 16.2, 24.3]: sum 48.6
    # example 1: x0 = [0, 1, 4]; deep relu(0 + 2 - 4 + .5) = 0 -> 0.25;
    # x0·w = 8; x1 = [0.1, 9.2, 36.3]: sum 45.6
    out = dcn.make_forward(cfg)(p, embs, feats)
    assert out.tolist() == pytest.approx([7.75 + 48.6 - 1, 0.25 + 45.6 - 1])


def _bst_loop(cfg, p, item, user, numeric, mask):
    """BST one example and one token at a time, in numpy."""
    b, hist = mask.shape
    d, dh = cfg["embedding_dim"], cfg["head_dim"]
    out = []
    for i in range(b):
        n = int(mask[i].sum())
        toks = [item[b + i * hist + j] + p["pos"][j] for j in range(n)]
        toks.append(item[i] + p["pos"][hist])
        x = np.array(toks)

        def ln(v, pre):
            mu, var = v.mean(), ((v - v.mean()) ** 2).mean()
            return (v - mu) / math.sqrt(var + 1e-6) * p[pre + ".g"] \
                + p[pre + ".b"]

        qkv = np.array([ln(v, "blocks.0.ln1") @ p["blocks.0.qkv.w"]
                        + p["blocks.0.qkv.b"] for v in x])
        q, k, v = qkv[:, :dh], qkv[:, dh:2 * dh], qkv[:, 2 * dh:]
        att = []
        for r in range(len(x)):
            s = np.array([q[r] @ k[c] / math.sqrt(dh) for c in range(len(x))])
            w = np.exp(s - s.max())
            att.append((w / w.sum()) @ v)
        x = x + np.array(att) @ p["blocks.0.proj.w"] + p["blocks.0.proj.b"]
        y = np.maximum(np.array([ln(r, "blocks.0.ln2") for r in x])
                       @ p["blocks.0.ffn1.w"] + p["blocks.0.ffn1.b"], 0)
        x = x + y @ p["blocks.0.ffn2.w"] + p["blocks.0.ffn2.b"]
        h = np.concatenate([user[i], x.mean(0), x[-1], numeric[i]])
        h = np.maximum(h @ p["dnn.0.w"] + p["dnn.0.b"], 0)
        out.append(float((h @ p["dnn_logits.w"] + p["dnn_logits.b"])[0]))
    assert d == x.shape[1]
    return np.array(out)


def test_bst_forward_against_a_token_loop():
    cfg = {"embedding_dim": 2, "num_heads": 1, "head_dim": 2, "num_blocks": 1,
           "dnn_hidden": [3]}
    rng = np.random.default_rng(0)
    shapes = {"pos": (3, 2), "blocks.0.ln1.g": (2,), "blocks.0.ln1.b": (2,),
              "blocks.0.ln2.g": (2,), "blocks.0.ln2.b": (2,),
              "blocks.0.qkv.w": (2, 6), "blocks.0.qkv.b": (6,),
              "blocks.0.proj.w": (2, 2), "blocks.0.proj.b": (2,),
              "blocks.0.ffn1.w": (2, 2), "blocks.0.ffn1.b": (2,),
              "blocks.0.ffn2.w": (2, 2), "blocks.0.ffn2.b": (2,),
              "dnn.0.w": (7, 3), "dnn.0.b": (3,), "dnn_logits.w": (3, 1),
              "dnn_logits.b": (1,)}
    p = {k: rng.normal(size=s) for k, s in shapes.items()}
    mask = np.array([[1.0, 0.0], [1.0, 1.0], [0.0, 0.0]])
    item = rng.normal(size=(3 + 3 * 2, 2))
    user = rng.normal(size=(3, 2))
    numeric = rng.normal(size=(3, 1))
    got = bst.make_forward(cfg)(
        {k: torch.tensor(v) for k, v in p.items()},
        {"item": torch.tensor(item), "user": torch.tensor(user)},
        {"mask": torch.tensor(mask), "numeric": torch.tensor(numeric)})
    want = _bst_loop(dict(cfg, embedding_dim=2), p, item, user, numeric,
                     mask)
    np.testing.assert_allclose(got.numpy(), want.reshape(-1), rtol=1e-12)


def test_first_steps_of_adam_and_group_adam_by_hand():
    var = torch.tensor([[1.0]], dtype=torch.float64)
    g = torch.tensor([[0.5]], dtype=torch.float64)
    # step 1: lr·sqrt(1 - b2)/(1 - b1) · m/(eps + sqrt(v)) = lr · g/|g|
    new, slots, _ = sparse.adam_rows(var, torch.zeros(1, 2).double(), g,
                                     0.1, 1)
    assert float(new) == pytest.approx(0.9, abs=1e-7)
    assert slots[0].tolist() == pytest.approx([0.05, 0.00025])
    new, slots, black = sparse.group_adam_rows(
        var, torch.zeros(1, 3).double(), g, 0.1, 1)
    assert float(new) == pytest.approx(0.9, abs=1e-7)
    assert not bool(black)
    # a large l21 zeroes the group and blacklists it
    new, _, black = sparse.group_adam_rows(
        var, torch.zeros(1, 3).double(), g, 0.1, 1, l21=100.0)
    assert float(new) == 0.0 and bool(black)


def test_fresh_rows_follow_the_kv_init_rule():
    """The reference's rule against the program's, at a few ids."""
    from tfplus_tpu_torch.kv import table as kvt
    from benchlib import inputs
    pool = torch.randn(97, 4)
    ids = torch.tensor([0, 1, 12345, inputs.FRESH_BASE + 7, (1 << 62) + 3])
    t = kvt.create(4, 64, initializer=pool, device="cpu")
    want = kvt._init_rows_for(t, inputs.encode(ids))
    got = sparse.fresh_rows(ids, pool, dtype=torch.float32)
    assert torch.equal(got, want)


def test_training_steps_of_a_linear_model_by_hand():
    """logit = row · w over one table: step 1's gradients by hand."""
    ids = np.array([3, 3, 5])
    rows = {3: 0.5, 5: -1.0}
    labels = np.array([1.0, 0.0, 1.0])

    def forward(p, embs, feats):
        return embs["t"][:, 0] * p["w"][0]

    out = sparse.train(
        forward, {"w": torch.tensor([2.0])},
        [{"ids": {"t": ids}, "features": np.zeros(3), "labels": labels}],
        lambda name, x: torch.tensor([[rows[int(i)]] for i in x]),
        {"rule": "adam", "lr": 0.1}, {"rule": "adam", "lr": 0.1})
    x = np.array([rows[int(i)] for i in ids])
    sig = 1 / (1 + np.exp(-2.0 * x))
    assert out["losses"][0] == pytest.approx(float(np.mean(
        np.log1p(np.exp(-2.0 * x)) + (1 - labels) * 2.0 * x)))
    assert float(out["grads"]["w"][0]) == pytest.approx(
        float(np.mean((sig - labels) * x)))
    g_rows = [np.sum((sig - labels)[ids == i]) * 2.0 / 3 for i in (3, 5)]
    assert out["grads"]["table:t"][:, 0].tolist() == pytest.approx(g_rows)
    assert out["ids"]["t"].tolist() == [3, 5]


def test_the_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.dcn, reference.bst, reference.sparse; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('tfplus_tpu_torch', 'tfplus_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(BENCH))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for path in (BENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "tfplus_tpu" not in text.replace("``tfplus_tpu_torch``", "")
        assert "import jax" not in text


@pytest.mark.parametrize("name", sorted(sparse.RULES))
def test_each_rules_port_keeps_its_slot_width(name):
    """The rule table names the port's constructor and its slot width, the
    one place the benchmark knows the width from (``rows_bytes`` too)."""
    from tfplus_tpu_torch import train
    from benchlib.program import _kwargs
    rule = sparse.RULES[name]
    spec = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "l1": 0.0, "l2": 0.0,
            "l21": 0.0}
    opt = getattr(train, rule.port)(**_kwargs(rule, spec))
    assert opt.rule.slot_width == rule.width
    assert {"sgd": 0, "adam": 2, "group_adam": 3}[name] == rule.width


def test_sgd_rows_against_the_ports_gradient_descent():
    """The reference's SGD on a small table's touched rows against the
    port's ``GradientDescentOptimizer``; untouched rows stay as they were."""
    from tfplus_tpu_torch import kv, train
    from benchlib import inputs
    dim, lr = 4, 0.5
    table = kv.create(dim, 64, device="cpu")
    ids = torch.arange(1, 21, dtype=torch.int64)
    rows = torch.randn(20, dim)
    kv.insert(table, inputs.encode(ids), rows)
    opt = train.GradientDescentOptimizer()
    table = opt.init(table)
    touched = torch.tensor([3, 7, 8, 15])
    g = torch.randn(4, dim)
    slot = kv.find(table, inputs.encode(touched)).slot
    opt.apply(table, slot, g, lr=lr, step=1)
    want, slots, black = sparse.sgd_rows(rows[touched - 1], rows.new_zeros(
        (4, 0)), g, lr, 1)
    assert black is None and slots.shape == (4, 0)
    held = table.payload[kv.find(table, inputs.encode(ids)).slot.long()]
    assert torch.equal(held[touched - 1], want)
    rest = torch.ones(20, dtype=torch.bool)
    rest[touched - 1] = False
    assert torch.equal(held[rest], rows[rest])


@pytest.mark.parametrize("name", sorted(sparse.DENSE_RULES))
def test_dense_rules_against_torch_optim(name):
    """Three steps of the reference's dense rule against ``torch.optim``'s
    class of the same rule, in float64."""
    rule = sparse.DENSE_RULES[name]
    gen = torch.Generator().manual_seed(3)
    p0 = torch.randn(5, 3, generator=gen, dtype=torch.float64)
    grads = [torch.randn(5, 3, generator=gen, dtype=torch.float64)
             for _ in range(3)]
    p = torch.nn.Parameter(p0.clone())
    opt = getattr(torch.optim, rule.port)([p], lr=0.3)
    ref, state = p0.clone(), None
    for t, g in enumerate(grads, start=1):
        p.grad = g.clone()
        opt.step()
        ref, state = rule.update(ref, state, g, 0.3, t)
    torch.testing.assert_close(p.detach(), ref, rtol=1e-13, atol=1e-15)


def test_an_unknown_rule_raises_before_any_table_is_built(tiny):
    """Sparse or dense, a rule the benchmark does not know raises a
    ValueError that names it, in the program before the adapter builds a
    table and in the reference's training."""
    from benchlib.program import SparseProgram
    files, _ = tiny
    cfg = files.config("dcn_criteo")
    mix = files.traffic("train_zipf")

    class Adapter:
        def tables(self, cfg):
            raise AssertionError("a table was built")

    for key, rule in (("sparse_optimizer", "adagrad"),
                      ("dense_optimizer", "rmsprop")):
        bad = dict(cfg, **{key: dict(cfg[key], rule=rule)})
        with pytest.raises(ValueError, match=rule):
            SparseProgram(Adapter(), bad, mix, 1, "cpu")
    batch = {"ids": {"t": np.array([1])}, "features": np.zeros(1),
             "labels": np.zeros(1)}
    with pytest.raises(ValueError, match="adagrad"):
        sparse.train(None, {}, [batch], None, {"rule": "adagrad", "lr": 1.0},
                     {"rule": "sgd", "lr": 1.0})
