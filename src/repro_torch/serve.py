"""Batched serving: prefill a prompt batch, then greedy decode with the
per-layer-kind KV caches (ring buffers for local attention).

Port of the JAX package's ``examples/serve.py``, with the same flags and
the same three printed lines. It runs the full configuration of ``--arch``
(``--smoke`` for the reduced one), with random weights drawn from
seed 0 and prompts from seed 1, on ``--device`` (CUDA by
default; it raises when there is none). Params are fp32; a bf16 copy of
the weights is made once up front (``transformer.cast_params``) and the
model runs in bf16. ``--gen`` tokens are generated: the first from the
prefill's logits, the rest by ``--gen - 1`` decode steps.

    python -m repro_torch.serve              # llama3-8b, B 4, P 4096, 32 decode steps
    python -m repro_torch.serve --smoke --device cpu --prompt-len 48 --gen 24
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.models import transformer

DTYPE = torch.bfloat16


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, batch, prompt_len, gen, device="cuda"):
    """Init, prefill and ``gen - 1`` greedy decode steps. Returns a dict:
    ``tokens`` (B, gen), ``prefill_logits`` and ``logits`` (the last
    step's; both fp32), ``prompts``,
    ``params`` (fp32), ``weights`` (the bf16 copy), ``cache`` and wall
    ``seconds`` of ``init``, ``prefill`` and ``decode`` (all steps), each
    ending in a device synchronize."""
    dev = device_lib.resolve(device)
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode")
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init(g, cfg, dev)
    weights = transformer.cast_params(params, DTYPE)
    g.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device=dev)
    cache = transformer.cache_init(cfg, batch, prompt_len + gen, dev)
    _sync(dev)
    t1 = time.perf_counter()
    prefill_logits, cache = transformer.prefill(weights, cfg, {"tokens": prompts},
                                                cache, dtype=DTYPE)
    logits = prefill_logits
    tok = torch.argmax(logits, -1)[:, None]
    _sync(dev)
    t2 = time.perf_counter()
    generated = [tok]
    for i in range(gen - 1):
        logits, cache = transformer.decode_step(weights, cfg, tok, cache,
                                                prompt_len + i, dtype=DTYPE)
        tok = torch.argmax(logits, -1)[:, None]
        generated.append(tok)
    tokens = torch.cat(generated, dim=1)
    _sync(dev)
    t3 = time.perf_counter()
    return {"tokens": tokens, "prefill_logits": prefill_logits, "logits": logits,
            "prompts": prompts,
            "params": params, "weights": weights, "cache": cache,
            "seconds": {"init": t1 - t0, "prefill": t2 - t1, "decode": t3 - t2}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--gen", type=int, default=33,
                    help="tokens to generate: one from prefill, then gen - 1 "
                         "decode steps")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (smoke_config)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    out = serve(cfg, args.batch, args.prompt_len, args.gen, args.device)
    B, P = args.batch, args.prompt_len
    print(f"[serve] arch={cfg.name} batch={B} prompt={P} "
          f"generated={out['tokens'].shape[1]}")
    print("[serve] first row token ids:", out["tokens"][0, :16].tolist(), "...")
    print("[serve] all finite logits:", bool(torch.isfinite(out["logits"]).all()))
    return out


if __name__ == "__main__":
    main()
