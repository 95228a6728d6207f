"""Helper process of tests/test_torch_dryrun.py (not a test module).

``python tests/torch_dryrun_worker.py OUT`` first checks that
`launch.dryrun.start_world` refuses a process that already has a default
group (a gloo world of one), then makes itself rank 0 of a fake world of
four and, on the (2, 2) mesh, traces with ``FlopCounterMode`` the sharded
train step of each case of `CASES` on ``meta`` tensors, and the
unsharded `make_train_step` on one batch slice (the rows a rank of the
split computes); it also records the collectives `dryrun._CostMode`
sees for one all-reduce and one all-gather on each mesh dimension.
Writes ``OUT`` (JSON).  It imports torch and the port alone.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = ("gemma-2b", "mixtral-8x22b")
B, S = 4, 64


def main(out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    import torch_sharding_worker as SW
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec, input_specs
    from repro_torch.core.policy_core import all_gather_stack
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    from repro_torch.parallel import sharding as PS
    from repro_torch.train import steps as ST
    from repro_torch.train.optimizer import OptConfig

    got = {}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        D.start_world(4)
    except RuntimeError as e:
        got["refusal"] = str(e)
    dist.destroy_process_group()
    D.start_world(4)
    rules = PS.make_rules(M.make_mesh((2, 2), "cpu"))
    shape = ShapeSpec("train_4k", "train", S, B)
    for arch in CASES:
        cfg = SW.case_fields(get_config(arch, reduced=True))
        sharded = D.trace_step(cfg, shape, rules)
        rows = ST.local_rows(rules, B, cfg)
        (batch,), _ = input_specs(cfg, ShapeSpec("slice", "train", S, rows))
        step = ST.make_train_step(cfg, OptConfig())
        with FlopCounterMode(display=False) as fc:
            step(ST.abstract_state(cfg), batch)
        got[arch] = dict(sharded=sharded["flops"],
                         unsharded=float(fc.get_total_flops()), rows=rows,
                         n_coll=len(sharded["coll"]))
    mesh = rules.mesh
    x = torch.empty(6, 10, device="meta")
    cost = D._CostMode()
    with cost:
        for i in range(mesh.ndim):
            PS.all_reduce(x, group=mesh.get_group(i))
            all_gather_stack(x, mesh.get_group(i))
    got["coll"] = [list(c) for c in cost.coll]
    got["summary"] = D.collectives_of(cost.coll)
    with open(out, "w") as f:
        json.dump(got, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    main(sys.argv[1])
