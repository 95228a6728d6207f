"""End-to-end training driver: the port's counterpart of the JAX package's
``launch/train.py``, on the card by default.

Wires the subsystems together: arch registry -> model -> train step ->
deterministic data pipeline -> straggler-aware checkpointing (the
paper's scheduler on the checkpoint write path) -> restart/resume.

Reduced config on the card, local object store, injected straggler::

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch gemma-2b --reduced --steps 60 --ckpt-every 20 \\
        --ckpt-dir /tmp/ckpt --policy trh --inject-straggler 2

``--device cpu`` runs the same on the CPU.  The port trains on one card:
``--mesh`` takes ``none`` only.  An encoder-decoder (whisper-tiny) is
refused: the token batches carry no frames, so the JAX launcher cannot
train one either; train it through `train.make_train_step` on batches
``{frames, tokens, targets}``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.policies import PolicyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.io.client import IOClientConfig
from repro_torch.train import (OptConfig, init_state, load_state,
                               make_train_step)


def build_mesh(spec: str):
    """``none`` (one card): None.  Sharded training is not ported."""
    if spec != "none":
        raise NotImplementedError(
            f"--mesh {spec}: sharded training (DTensor specs for "
            "parallel/sharding.py and launch/shardutil.py) is not ported "
            "yet (ROADMAP Queue A13); use --mesh none")
    return None


def make_checkpointer(args, n_servers: int = 8) -> Checkpointer:
    io_cfg = IOClientConfig(
        policy=PolicyConfig(name=args.policy, threshold=args.threshold),
        stripe_size=1 << 20)
    return Checkpointer(
        args.ckpt_dir, n_servers=n_servers,
        cfg=CheckpointConfig(shard_size_mb=4.0, keep_n=3,
                             async_save=args.async_ckpt, io=io_cfg))


def train(args) -> dict:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.enc_dec:
        # the JAX package's launcher fails on the same batches, at its
        # loss's batch["frames"]
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: this launcher's "
            "SyntheticTokens batches carry no frames, so it cannot train "
            "one (nor can the JAX package's launch/train.py); train it "
            "through train.make_train_step on batches {frames, tokens, "
            "targets}")
    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                        total_steps=args.steps)
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len or 64,
        global_batch=args.batch, seed=args.seed))
    build_mesh(args.mesh)

    ckpt = make_checkpointer(args) if args.ckpt_dir else None
    if args.inject_straggler >= 0 and ckpt is not None:
        ckpt.store.set_write_delay(args.inject_straggler, 0.05)

    state = init_state(torch.Generator(device=dev).manual_seed(args.seed),
                       cfg, dev)
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None and not args.fresh:
        state = load_state(state, ckpt.restore(target=state))
        start_step = int(state.step)
        print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg)
    metrics = {}
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = data.batch_at(step, dev)
        state, metrics = step_fn(state, batch)
        if args.ckpt_every and ckpt is not None \
                and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, block=not args.async_ckpt)
        if (step + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step {step+1:5d} loss={m['loss']:.4f} "
                  f"nll={m.get('nll', 0):.4f} "
                  f"gnorm={m.get('grad_norm', 0):.3f} "
                  f"({(time.time()-t0)/(step-start_step+1):.2f}s/step)",
                  flush=True)
    out = {k: float(v) for k, v in metrics.items()}
    if ckpt is not None:
        ckpt.save(args.steps, state)
        out["ckpt_stats"] = ckpt.client.stats()
        ckpt.close()
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (smoke) config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="none",
                    help="'none' (sharded meshes are not ported)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore existing checkpoints")
    ap.add_argument("--policy", default="trh",
                    choices=["rr", "mlml", "trh", "nltr", "two_choice", "ect"])
    ap.add_argument("--threshold", type=float, default=4.0)
    ap.add_argument("--inject-straggler", type=int, default=-1,
                    help="object-server id to slow down (-1 = none)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main():
    out = train(parse_args())
    print("[train] final:", {k: v for k, v in out.items()
                             if not isinstance(v, dict)})


if __name__ == "__main__":
    main()
