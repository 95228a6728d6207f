"""Batched serving: prefill a batch of prompts, then decode.

The port's counterpart of the JAX package's ``launch/serve.py``, on the
card by default::

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch gemma-2b --batch 4 --prompt-len 512 --gen 16

The prompt goes through `forward_prefill` with the flash kernel
(``use_pallas_attn``) and fills the ring KV caches; the first token is the
argmax of the prefill's last logits, then ``gen - 1`` greedy
`decode_step`s follow.  Weights are random, from ``--seed``.  An
encoder-decoder (whisper-tiny) takes stub frames (B, enc_seq, d) from
their own seeded stream (`stub_frames`), encodes them once and serves
through `models.encdec` (its decoder's self attention on the flash
kernel).  A VLM (qwen2-vl) is served on its tokens alone, each M-RoPE
stream at the token's position, as the JAX package's serve does;
`generate` takes a batch's positions and patch embeddings.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import make_decode_step

PROMPT_SEED = 2     # the prompts' own stream, as in the JAX serve module
FRAMES_SEED = 1     # the stub frames' own stream, likewise


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def generate(params, prompts: torch.Tensor, cfg: ModelConfig, gen: int,
             frames=None, positions=None, patch_embeds=None):
    """Greedy generation of ``gen`` tokens after ``prompts`` (B, S), an
    encoder-decoder's against ``frames`` (B, S_enc, d).  A VLM's batch
    may carry M-RoPE ``positions`` (3, B, S) and ``patch_embeds`` (B, P,
    d) for the prefill's forward (`transformer.forward_prefill`, whose
    caches hold the text alone).  Returns (tokens (B, gen) int64, prefill
    seconds, decode seconds), each phase ended by a synchronize on the
    card."""
    dev = prompts.device
    s = prompts.shape[1]
    batch, prefill = {"tokens": prompts}, T.forward_prefill
    for name, x in (("positions", positions), ("patch_embeds", patch_embeds)):
        if x is not None:
            batch[name] = x
    if cfg.enc_dec:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass its "
                             "frames (B, enc_seq, d_model)")
        batch, prefill = dict(batch, frames=frames), E.forward_prefill
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(
        params, batch, dataclasses.replace(cfg, use_pallas_attn=True),
        cache_len=s + gen)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    decode = make_decode_step(cfg)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = decode(params, caches, tok, s + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return torch.cat(out, dim=1), t_prefill, t_decode


def stub_frames(cfg: ModelConfig, batch: int, device) -> torch.Tensor:
    """An encoder-decoder's stub frame embeddings (B, enc_seq, d_model)
    float32, standard normal from their own stream (`FRAMES_SEED`)."""
    dev = resolve_device(device)
    return torch.randn((batch, cfg.enc_seq, cfg.d_model), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           FRAMES_SEED))


def setup(args):
    """(cfg, params, prompts (B, S) int64) of a serving run: the same
    for the same arguments, so a caller can rebuild a run's inputs (an
    encoder-decoder's frames: `stub_frames`)."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    init = E.init_encdec if cfg.enc_dec else T.init_lm
    params = init(torch.Generator(device=dev).manual_seed(args.seed), cfg,
                  device=dev)
    prompts = torch.randint(
        1, cfg.vocab_size, (args.batch, args.prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(PROMPT_SEED))
    return cfg, params, prompts


def serve(args) -> dict:
    cfg, params, prompts = setup(args)
    b, s = prompts.shape
    frames = stub_frames(cfg, b, prompts.device) if cfg.enc_dec else None
    tokens, t_prefill, t_decode = generate(params, prompts, cfg, args.gen,
                                           frames)
    gen = tokens.cpu().numpy()
    toks_per_s = b * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"[serve] arch={cfg.name} batch={b} prompt={s} gen={args.gen}")
    print(f"[serve] prefill {t_prefill:.2f}s, decode {t_decode:.2f}s "
          f"({toks_per_s:.1f} tok/s)")
    print(f"[serve] sample row 0: {gen[0][:16].tolist()}")
    return {"tokens": gen, "tok_per_s": toks_per_s, "prefill_s": t_prefill,
            "decode_s": t_decode}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main():
    serve(parse_args())


if __name__ == "__main__":
    main()
