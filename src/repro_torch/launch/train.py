"""End-to-end training driver: the port's counterpart of the JAX package's
``launch/train.py``, on the card by default.

Wires the subsystems together: arch registry -> model -> train step ->
deterministic data pipeline -> straggler-aware checkpointing (the
paper's scheduler on the checkpoint write path) -> restart/resume.

Reduced config on the card, local object store, injected straggler::

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch gemma-2b --reduced --steps 60 --ckpt-every 20 \\
        --ckpt-dir /tmp/ckpt --policy trh --inject-straggler 2

``--device cpu`` runs the same on the CPU.  ``--mesh`` names a mesh of
the world's ranks (``2``, ``1x2``, ``2x2``, ``2x2x2``: ``("data",)``,
``("data", "model")`` or ``("pod", "data", "model")``); the state then
lives as DTensors placed by the JAX package's specs and every step is
`train.make_sharded_train_step`'s.  The world comes from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and
``MASTER_ADDR``/``MASTER_PORT`` for ``--dist-init env://``, or a
``file://`` path), NCCL on the card and gloo with ``--device cpu``; a
gloo world of four on the CPU::

    for r in 0 1 2 3; do RANK=$r WORLD_SIZE=4 PYTHONPATH=src \\
        python -m repro_torch.launch.train --arch gemma-2b --reduced \\
        --device cpu --mesh 2x2 --dist-init file:///tmp/world4 & done

A world of one rank runs unsharded whatever ``--mesh`` says, as the JAX
launcher does on one device.  Under a mesh every rank gathers the state
for a checkpoint and rank 0 alone writes it, between barriers; a resume
restores the whole state on rank 0, broadcasts it and places it, so the
checkpoints are an unsharded run's.  An encoder-decoder (whisper-tiny) is
refused: the token batches carry no frames, so the JAX launcher cannot
train one either; train it through `train.make_train_step` on batches
``{frames, tokens, targets}``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.policies import PolicyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.io.client import IOClientConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.shardutil import state_shardings
from repro_torch.parallel import sharding as PS
from repro_torch.train import (OptConfig, abstract_state, init_state,
                               load_state, make_train_step)
from repro_torch.train.steps import (gather_state, make_sharded_train_step,
                                     shard_state)


def build_mesh(spec: str, device_type: str = "cuda"):
    """``none``, or a world of one rank: None (the JAX launcher's at one
    device).  Otherwise a ``DeviceMesh`` of the spec's shape ("2x2"),
    named as `launch.mesh.lm_axes` names it; the product must divide the
    world size."""
    if spec == "none":
        return None
    try:
        dims = tuple(int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: 'none' or sizes joined by "
                         "'x', e.g. '2x4' or '2x2x2'") from None
    tmesh.lm_axes(len(dims))
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return tmesh.make_mesh(dims, device_type)


def init_world(args) -> None:
    """Join the world torchrun's environment names (``WORLD_SIZE`` > 1)
    at ``args.dist_init``, unless a process group is up already."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return
    if args.device.startswith("cuda"):
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        "gloo" if args.device == "cpu" else "nccl",
        init_method=args.dist_init, rank=int(os.environ["RANK"]),
        world_size=world)


def _broadcast_state(state) -> None:
    """Rank 0's tensors of ``state`` (whole) to every rank, in place, in
    the parameters' order (a restored state's moments are keyed in
    another)."""
    params = state.params.state_dict()
    with torch.no_grad():
        for t in (*params.values(), *(state.opt.m[k] for k in params),
                  *(state.opt.v[k] for k in params), state.opt.count,
                  state.step):
            PS.broadcast(t, src=0)


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
    init_world(args)
    mesh = build_mesh(args.mesh, dev.type)
    rank = dist.get_rank() if mesh is not None else 0

    # under a mesh rank 0 alone reads and writes the checkpoints
    ckpt = make_checkpointer(args) if args.ckpt_dir and rank == 0 else None
    if args.inject_straggler >= 0 and ckpt is not None:
        ckpt.store.set_write_delay(args.inject_straggler, 0.05)

    state = init_state(torch.Generator(device=dev).manual_seed(args.seed),
                       cfg, dev)
    start_step = 0
    resume = [ckpt is not None and ckpt.latest_step() is not None
              and not args.fresh]
    if mesh is not None:
        dist.broadcast_object_list(resume, src=0)
    if resume[0]:
        if ckpt is not None:
            state = load_state(state, ckpt.restore(target=state))
        if mesh is not None:
            _broadcast_state(state)
        start_step = int(state.step)
        if rank == 0:
            print(f"[train] resumed from step {start_step}")

    if mesh is not None:
        rules = PS.make_rules(mesh)
        state = shard_state(state, state_shardings(abstract_state(cfg),
                                                   rules))
        step_fn = make_sharded_train_step(cfg, opt_cfg, rules)
    else:
        step_fn = make_train_step(cfg, opt_cfg)

    def save(step: int, block) -> None:
        if mesh is None:
            ckpt.save(step, state, block=block)
            return
        whole = gather_state(state)
        dist.barrier()
        if ckpt is not None:
            ckpt.save(step, whole, block=block)
        dist.barrier()

    metrics = {}
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = data.batch_at(step, dev)
        state, metrics = step_fn(state, batch)
        if args.ckpt_every and args.ckpt_dir \
                and (step + 1) % args.ckpt_every == 0:
            save(step + 1, not args.async_ckpt)
        if (step + 1) % args.log_every == 0 and rank == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step {step+1:5d} loss={m['loss']:.4f} "
                  f"nll={m.get('nll', 0):.4f} "
                  f"gnorm={m.get('grad_norm', 0):.3f} "
                  f"({(time.time()-t0)/(step-start_step+1):.2f}s/step)",
                  flush=True)
    out = {k: float(v) for k, v in metrics.items()}
    if args.ckpt_dir:
        save(args.steps, None)
    if ckpt is not None:
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
                    help="'none' or e.g. '2x4' / '2x2x2'")
    ap.add_argument("--dist-init", default="env://",
                    help="the world's init method when WORLD_SIZE > 1")
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
    if not dist.is_initialized() or dist.get_rank() == 0:
        print("[train] final:", {k: v for k, v in out.items()
                                 if not isinstance(v, dict)})
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
