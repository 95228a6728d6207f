"""Straggler + node-failure recovery on the checkpoint write path, on the
PyTorch port (the scenario of examples/straggler_recovery.py).

    PYTHONPATH=src python examples/straggler_recovery_torch.py      # card
    PYTHONPATH=src python examples/straggler_recovery_torch.py --device cpu

Scenario (the paper's Fig. 1, on a real local object store):
  * 8 object storage servers; server 2 becomes a straggler (slow writes),
    server 5 dies outright mid-run;
  * a training job checkpoints through (a) round-robin placement and
    (b) the log-assisted ECT policy;
  * the scheduler masks the dead server after the first failed write,
    retries on the next-best target, and steers bytes away from the
    straggler — RR keeps paying the straggler tax on every save;
  * after the incident, the metadata maintainer migrates redirected
    objects back to their default homes (redirect tables drain to zero).
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.policies import PolicyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.io import IOClientConfig, MaintainerThread
from repro_torch.io.striping import MB
from repro_torch.train import (OptConfig, init_state, load_state,
                               make_train_step)


def run(policy: str, dev: torch.device) -> dict:
    cfg = get_config("stablelm-1.6b", reduced=True)
    pipe = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=4, seed=0))
    step_fn = make_train_step(cfg, OptConfig(peak_lr=1e-3))

    def fresh():
        return init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)

    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, n_servers=8, cfg=CheckpointConfig(
            shard_size_mb=0.5, keep_n=10,
            io=IOClientConfig(policy=PolicyConfig(policy, threshold=0.02),
                              stripe_size=MB // 4)))
        ck.store.set_write_delay(2, 0.2)       # straggler: 200 ms/MB
        state = fresh()
        t0 = time.time()
        for i in range(6):
            state, _ = step_fn(state, pipe.batch_at(i, dev))
            if i == 3:
                ck.store.fail_server(5)        # node dies mid-run
            ck.save(i + 1, state)
        wall = time.time() - t0
        stats = ck.client.stats()
        per_server = []
        for s in range(8):
            sd = os.path.join(d, "objects", f"server_{s:04d}")
            per_server.append(sum(
                os.path.getsize(os.path.join(sd, f))
                for f in os.listdir(sd) if f.endswith(".bin")) / MB)
        # restore works even with server 5 still dead
        template = fresh()
        restored = load_state(template, ck.restore(target=template))
        if int(restored.step) != 6:
            raise RuntimeError(f"restored step {int(restored.step)}, not 6")

        # heal + let the maintainer migrate redirected objects home
        ck.store.heal_server(5)
        mt = MaintainerThread(ck.store, interval_s=0.01, max_objects=64)
        mt.start()
        deadline = time.time() + 10
        while ck.store.redirect_count() and time.time() < deadline:
            time.sleep(0.05)
        mt.stop()
        redirects_left = ck.store.redirect_count()
        ck.close()
        return {"wall_s": wall, "stats": stats, "per_server_mb": per_server,
                "redirects_after_maintainer": redirects_left}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args().device)
    print(f"== checkpointing under a straggler (srv 2) + failure (srv 5), "
          f"training on {dev} ==")
    for policy in ("rr", "ect"):
        r = run(policy, dev)
        st = r["stats"]
        mb = r["per_server_mb"]
        print(f"\npolicy={policy}")
        print(f"  wall time          : {r['wall_s']:.2f}s")
        print(f"  failed writes      : {int(st['failed_writes'])} "
              f"(retried on next-best server)")
        print(f"  probe messages     : {int(st['probe_messages'])}")
        print(f"  MB on straggler(2) : {mb[2]:.1f}")
        print(f"  MB on dead srv (5) : {mb[5]:.1f}")
        print(f"  MB per server      : " +
              " ".join(f"{x:5.1f}" for x in mb))
        print(f"  redirects after maintainer: "
              f"{r['redirects_after_maintainer']}")


if __name__ == "__main__":
    main()
