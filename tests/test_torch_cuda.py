"""The port's CUDA row kernels on the card.

Each kernel is held bit for bit against its plain PyTorch version (these are
copies and single adds), including the narrow-word paths for odd widths and
misaligned rows, and the table engine's serving calls on the card leave the
same header and payload as the same calls on the CPU. Marked ``cuda``: every
test skips without a card. On a machine with a card and without JAX, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from tfplus_tpu_torch import kv
from tfplus_tpu_torch.ops import rowops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _values(gen, c, w, dtype, device):
    return torch.randn(c, w, generator=gen).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 3, 64, 129, 384])
def test_gather_matches_plain(cuda, dtype, width):
    gen = torch.Generator().manual_seed(width)
    c, n = 4099, 5000
    values = _values(gen, c, width, dtype, cuda)
    idx = torch.randint(-7, c + 7, (n,), generator=gen, dtype=torch.int32)
    idx = idx.to(cuda)
    before = rowops.gather_rows.launches
    got = rowops.gather_rows(values, idx)
    assert rowops.gather_rows.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, rowops.gather_rows_plain(values, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 3, 64, 129, 384])
@pytest.mark.parametrize("add", [False, True])
def test_scatter_matches_plain(cuda, dtype, width, add):
    gen = torch.Generator().manual_seed(1000 + width)
    c, n = 4099, 3000
    values = _values(gen, c, width, dtype, cuda)
    rows = _values(gen, n, width, dtype, cuda)
    idx = torch.randperm(c + 40, generator=gen)[:n].to(torch.int32) - 20
    idx = idx.to(cuda)
    want = rowops.scatter_rows_plain(values.clone(), idx, rows, add)
    before = rowops.scatter_rows.launches
    got = rowops.scatter_rows(values, idx, rows, add=add)
    assert got is values and rowops.scatter_rows.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_misaligned_rows_take_the_narrow_words(cuda):
    gen = torch.Generator().manual_seed(7)
    c, w = 1000, 8
    buf = torch.randn(c * w + 1, generator=gen).to(cuda)
    values = buf[1:].view(c, w)                    # 4-byte aligned only
    idx = torch.randint(0, c, (700,), generator=gen,
                        dtype=torch.int32).to(cuda)
    assert torch.equal(rowops.gather_rows(values, idx),
                       rowops.gather_rows_plain(values, idx))
    rows = torch.randn(700, w, generator=gen).to(cuda)
    uidx = torch.randperm(c, generator=gen)[:700].to(torch.int32).to(cuda)
    want = rowops.scatter_rows_plain(values.clone(), uidx, rows)
    assert torch.equal(rowops.scatter_rows(values, uidx, rows), want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    values = torch.zeros(16, 8, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        rowops.gather_rows(values[:, :4], idx)             # not contiguous
    with pytest.raises(TypeError):
        rowops.gather_rows(values, idx.long())
    with pytest.raises(ValueError):
        rowops.gather_rows(values, idx.cpu())               # two devices
    with pytest.raises(TypeError):
        rowops.scatter_rows(values.half(), idx, torch.zeros(4, 8, device=cuda,
                                                            dtype=torch.half))


def test_serving_calls_on_the_card_match_the_cpu(cuda):
    """The same table calls on the card (kernels) and on the CPU (plain
    versions) leave bit-identical tables and return identical rows."""
    rng = np.random.RandomState(3)
    tables = {d: kv.create(16, 1024, max_probes=8, init_pool_rows=100,
                           seed=5, device=d) for d in ("cpu", cuda)}
    ids = rng.randint(0, 1 << 40, 600).astype(np.int64)
    more = rng.randint(0, 1 << 40, 200).astype(np.int64)
    rows = rng.randn(200, 16).astype(np.float32)
    out = {}
    for d, t in tables.items():
        res = kv.lookup_or_insert(t, kv.encode_ids(ids, device=d), day=3)
        kv.insert(t, kv.encode_ids(more, device=d),
                  torch.from_numpy(rows).to(d), day=4)
        probe = kv.encode_ids(np.concatenate([ids[::3], more, more + 1]),
                              device=d)
        out[d] = (res.rows, res.slot, kv.lookup_or_zeros(t, probe),
                  kv.lookup_with_init(t, probe), t.header, t.payload)
    for a, b in zip(out["cpu"], out[cuda]):
        assert torch.equal(a, b.cpu())
