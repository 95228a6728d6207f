"""Helper processes of tests/test_torch_serve_shard.py (not a test module).

``python tests/torch_serve_shard_worker.py RANK WORLD STORE OUT`` is one
rank of a gloo world of WORLD CPU processes, joined through the
``FileStore`` at STORE.  From the parameters and tokens in
``OUT/inputs.pt`` it runs, for every arch of `ARCHS` on each mesh of
`MESHES`, the port's sharded prefill step on the prompt batch and
`STEPS` sharded decode steps from empty caches of its rows; what it got
goes to ``OUT/rank<RANK>.pt``.  It imports torch and the port alone.
"""

from __future__ import annotations

import datetime
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCHS = ("gemma-2b", "mixtral-8x22b")
MESHES = ("2", "1x2")
B, S, CACHE, STEPS = 4, 12, 16, 3


def _ranks(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    import torch_sharding_worker as SW
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.shardutil import param_shardings
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as PS
    from repro_torch.train import steps as ST

    torch.set_num_threads(1)   # the ranks share the test machine's cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    inputs = torch.load(os.path.join(out, "inputs.pt"))
    got = {}
    for spec in MESHES:
        rules = PS.make_rules(tmesh.make_mesh(SW.mesh_dims(spec), "cpu"))
        for arch in ARCHS:
            cfg = SW.case_fields(get_config(arch, reduced=True))
            lm = T.build_lm(None, cfg, torch.device("meta"))
            lm.load_state_dict(inputs[arch], assign=True)
            lm = ST.shard_params(lm, param_shardings(lm, rules))
            logits = ST.make_sharded_prefill_step(cfg, rules)(
                lm, {"tokens": inputs["prompt"]})
            rows = ST.local_rows(rules, B, cfg)
            caches = T.init_caches(cfg, rows, CACHE, "cpu")
            decode = ST.make_sharded_decode_step(cfg, rules)
            steps = []
            for t in range(STEPS):
                out_t, caches = decode(lm, caches,
                                       inputs["decode"][:, t:t + 1], t)
                steps.append(out_t)
            got[spec, arch] = dict(prefill=logits, decode=steps,
                                   caches=caches, rows=rows)
    torch.save(got, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _ranks(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
