"""Serving entry point: batched prefill, then greedy decode on the ring KV
cache, on one card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --reduced 0 --batch 8 --prompt-len 2048 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --reduced 0 --batch 8 --prompt-len 2048 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --reduced 0 --batch 8 --prompt-len 4096
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --reduced 0 --batch 8 --prompt-len 2048 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
      --reduced 0 --batch 8 --prompt-len 416 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-11b --reduced 0 --batch 8 --prompt-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced 1

Every config of ``configs/`` serves (``qwen3-8b``, ``stablelm-1.6b``,
``stablelm-3b`` and ``arctic-480b`` too; arctic's 960 GB of bf16 weights
fit no card at full width). Weights are random, drawn from a
``torch.Generator(seed)`` on the device one tensor at a time (a float32
draw, then the model's dtype), so the 16.1 GB of rwkv6-7b in bf16 never
exist as float32 at once; prompt tokens, and the stubbed encoders'
outputs that whisper's and the VLM's prefill take (``audio_frames``,
``image_embeds``: normal draws, cast to the model's dtype), come from a
CPU generator of the same seed, so a seed gives the same inputs on every
device. The hand-written kernels carry the layers: flash attention in
every attention layer's prefill (with recurrentgemma's local window; the
encoder's and every cross-attention not causal, the cross-attention at
every decode step too), WKV-6 in every RWKV-6 layer's prefill and decode,
the decay scan in every RG-LRU layer's prefill. Without a card the entry
point raises unless ``--device cpu`` is given, which runs the plain
PyTorch versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.configs.base import InputShape, get_config, reduced
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.model import build_model
from repro_torch.train.steps import (make_decode_step, make_init_cache,
                                     make_prefill_step)


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (batch, new_tokens) int32, generated ids
    last_logits: torch.Tensor     # (batch, 1, padded_vocab) of the last step
    prefill_s: float
    decode_s_per_token: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(cfg, *, batch: int, prompt_len: int, new_tokens: int,
          device: DeviceLike = None, seed: int = 0,
          params: Optional[dict] = None) -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (with
    random frames or image embeddings for encdec and vlm models), then
    decode ``new_tokens`` tokens greedily (the first from the prefill)."""
    dev = resolve(device)
    if new_tokens < 1:
        raise ValueError("serve: new_tokens must be at least 1")
    total = prompt_len + new_tokens
    shape = InputShape("serve", total, batch, "decode")
    if params is None:
        params = build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(seed))
    # drawn on the CPU, so a seed gives the same inputs on every device
    host = torch.Generator().manual_seed(seed)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                      generator=host, dtype=torch.int32)}
    if cfg.family == "vlm":
        inputs["image_embeds"] = torch.randn(
            (batch, cfg.n_img_tokens, cfg.d_vision), generator=host)
    if cfg.family == "encdec":
        inputs["audio_frames"] = torch.randn(
            (batch, cfg.n_enc_tokens, cfg.d_model), generator=host)
    inputs = {k: v.to(dev, getattr(torch, cfg.dtype))
              if v.is_floating_point() else v.to(dev)
              for k, v in inputs.items()}

    prefill = make_prefill_step(cfg, shape)
    decode = make_decode_step(cfg, shape)
    cache = make_init_cache(cfg, shape, dev)()

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, inputs, cache)
    tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1
                       ).to(torch.int32)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens: List[torch.Tensor] = [tok]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        tok, logits, cache = decode(params, {"tokens": tok}, cache)
        tok = tok[:, None]
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return ServeResult(torch.cat(out_tokens, dim=1), logits,
                       t_prefill, t_decode / max(new_tokens - 1, 1))


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                new_tokens=args.new_tokens, device=args.device)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len}")
    print(f"prefill: {res.prefill_s * 1e3:.1f} ms   "
          f"decode: {res.decode_s_per_token * 1e3:.2f} ms/tok")
    print("generated token ids (first row):", res.tokens[0].tolist())
    return res


if __name__ == "__main__":
    main()
