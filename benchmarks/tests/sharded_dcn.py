"""A DCN adapter for a cell over several ranks: the benchmark's DCN adapter
with ``make_step``, the data-parallel step over row-sharded tables composed
from ``parallel.sharded_lookup(defer_meta=True)`` and
``parallel.sharded_apply_grads``. The tests copy this file into a test root
as ``models/<config>.py``, with ``FAULT`` set on its last line where the
copy plants a fault; ``benchmarks/models/`` holds no such adapter yet."""
import importlib.util
import os
from pathlib import Path

import benchlib

_bench = Path(benchlib.__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "bench_test_dcn_criteo", _bench / "models" / "dcn_criteo.py")
_dcn = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_dcn)

FAMILY = _dcn.FAMILY
tables, make_model, dense_spec = _dcn.tables, _dcn.make_model, _dcn.dense_spec
draw, forward_flops = _dcn.draw, _dcn.forward_flops
attention_work = _dcn.attention_work

# None; "scale_rank1": rank 1 scales its shards' rows before the first step;
# "rank1_exits": rank 1 exits (with 0) at the start of the second step
FAULT = None


def make_step(tp, model, opt, sparse_lr, group):
    """``step(state, batch) -> (state, loss, preds)`` of one rank: per table
    (sorted) the sharded lookup, the loss of this rank's slice, one backward
    of that loss over the ranks (so that the gradients summed over the
    ranks are those of the global batch's mean loss), the dense gradients
    summed over the group into the dense optimizer's step, then the sharded
    gradient exchange into the sparse optimizer with the 1-indexed step."""
    import torch
    import torch.distributed as dist
    par = tp.parallel
    world, rank = dist.get_world_size(group), dist.get_rank(group)

    def step(state, batch):
        dev = state.step.device
        if FAULT == "scale_rank1" and rank == 1 and int(state.step) == 0:
            for t in state.tables.values():
                t.payload[:, :t.config.dim] *= 1.5
        if FAULT == "rank1_exits" and rank == 1 and int(state.step) == 1:
            os._exit(0)
        rows, looks = {}, {}
        for name in sorted(state.tables):
            r, looks[name], state.tables[name] = par.sharded_lookup(
                state.tables[name],
                tp.kv.encode_ids(batch["ids"][name], device=dev),
                group=group, defer_meta=True, day=1)
            rows[name] = r.requires_grad_()
        preds = model.apply(state.dense, rows, torch.as_tensor(
            batch["features"], dtype=torch.float32, device=dev))
        loss = model.loss(preds, torch.as_tensor(batch["labels"], device=dev))
        params = list(state.dense.parameters())
        names = sorted(rows)
        grads = torch.autograd.grad(loss / world,
                                    params + [rows[n] for n in names],
                                    allow_unused=True)
        for p, g in zip(params, grads):
            g = torch.zeros_like(p) if g is None else g.contiguous()
            dist.all_reduce(g, group=group)
            p.grad = g
        state.opt_state.step()
        step_no = state.step + 1
        with torch.no_grad():
            for n, g in zip(names, grads[len(params):]):
                par.sharded_apply_grads(opt, state.tables[n], looks[n], g,
                                        group=group, lr=sparse_lr,
                                        step=step_no)
        return state._replace(step=step_no), loss.detach(), preds.detach()

    return step
