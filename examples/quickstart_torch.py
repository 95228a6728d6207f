"""Quickstart on the PyTorch port: train a small LM end-to-end with
straggler-aware checkpoints (the scenario of examples/quickstart.py).

    PYTHONPATH=src python examples/quickstart_torch.py              # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

What it shows:
  1. pick an assigned architecture (reduced config) from the registry;
  2. train a few hundred steps on the deterministic synthetic pipeline;
  3. checkpoint every 50 steps THROUGH the paper's scheduler (each shard is
     striped into objects placed by the TRH policy against the client-side
     statistic log — zero probe messages);
  4. kill the "job", restore from the newest committed checkpoint, and
     continue — as an uninterrupted run would.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.policies import PolicyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.io import IOClientConfig
from repro_torch.io.striping import MB
from repro_torch.train import (OptConfig, init_state, load_state,
                               make_train_step)

STEPS, CKPT_EVERY, KILL_AT = 200, 50, 120


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args().device)
    cfg = get_config("gemma-2b", reduced=True)
    opt = OptConfig(peak_lr=3e-3, warmup_steps=20, total_steps=STEPS)
    pipe = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=8, seed=0))
    step_fn = make_train_step(cfg, opt)

    def fresh():
        return init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)

    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, n_servers=8, cfg=CheckpointConfig(
            shard_size_mb=1.0, keep_n=2, async_save=True,
            io=IOClientConfig(policy=PolicyConfig("trh", threshold=0.5),
                              stripe_size=MB // 2)))

        print(f"== training {cfg.name} for {STEPS} steps on {dev} "
              f"(kill at {KILL_AT}) ==")
        state = fresh()
        for i in range(KILL_AT):
            state, m = step_fn(state, pipe.batch_at(i, dev))
            if (i + 1) % CKPT_EVERY == 0:
                ck.save(i + 1, state, block=False)
            if (i + 1) % 40 == 0:
                print(f"  step {i+1:4d} loss={float(m['loss']):.4f}")
        ck.wait_until_finished()
        print(f"!! job killed at step {KILL_AT}; newest committed "
              f"checkpoint: step {ck.latest_step()}")
        del state

        template = fresh()
        state = load_state(template, ck.restore(target=template))
        start = int(state.step)
        print(f"== restored at step {start}; resuming ==")
        for i in range(start, STEPS):
            state, m = step_fn(state, pipe.batch_at(i, dev))
            if (i + 1) % 40 == 0:
                print(f"  step {i+1:4d} loss={float(m['loss']):.4f}")
        ck.save(STEPS, state)

        stats = ck.client.stats()
        print("== done ==")
        print(f"  final loss           : {float(m['loss']):.4f}")
        print(f"  checkpoint objects   : {int(stats['writes'])} "
              f"({stats['total_mb']:.1f} MB)")
        print(f"  probe messages       : {int(stats['probe_messages'])} "
              f"(log-assisted scheduling)")
        print(f"  redirect rate        : {stats['redirect_rate']:.2f}")
        ck.close()


if __name__ == "__main__":
    main()
