"""Batched serving: prefill a prompt batch, then greedy decode with the
per-layer-kind caches (KV ring buffers for local attention, RG-LRU and
xLSTM states for the recurrent layers).

Port of the JAX package's ``examples/serve.py``, with the same flags and
the same three printed lines. It runs the full configuration of ``--arch``
(any of the ten; ``--smoke`` for the reduced one), with random weights
drawn from seed 0 and inputs from seed 1, on ``--device`` (CUDA by
default; it raises when there is none). The weights are drawn in fp32 and
every leaf the forward casts to the activation dtype is stored in bf16 as
it is drawn (``transformer.init(..., dtype=bf16)``: the same numbers as a
bf16 copy of fp32 params, without the fp32 model ever being whole); the
model runs in bf16. ``--gen`` tokens are generated: the first from the
prefill's logits, the rest by ``--gen - 1`` decode steps.

The frontend stubs take inputs drawn from the seed: hubert-xlarge (audio,
encoder only) prefills ``--prompt-len`` frame embeddings, runs the encoder
forward and decodes nothing; llava-next's prompt carries
``num_patch_tokens`` patch embeddings over its first positions.

On the meta device (``serve(..., device="meta")``) the run allocates
nothing and launches nothing: what ``launch.op_cost.OpCost`` reads to
predict a run's memory (a CPU generator stands in for the draws).

    python -m repro_torch.serve              # llama3-8b, B 4, P 4096, 32 decode steps
    python -m repro_torch.serve --smoke --device cpu --prompt-len 48 --gen 24
    python -m repro_torch.serve --arch xlstm-125m --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.models import transformer

DTYPE = torch.bfloat16


def prefill_inputs(cfg, batch, prompt_len, generator, device):
    """The prefill batch drawn from ``generator``: token ids (B, P); for the
    audio frontend frame embeddings (B, P, d_model) in their place; for the
    vision frontend patch embeddings (B, num_patch_tokens, d_model) too, at
    the embedding table's scale."""
    d = cfg.d_model
    if cfg.frontend == "audio":
        return {"frame_embeds": torch.randn((batch, prompt_len, d), generator=generator,
                                            device=device)}
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                      generator=generator, device=device)}
    if cfg.frontend == "vision":
        inputs["patch_embeds"] = torch.randn(
            (batch, cfg.num_patch_tokens, d), generator=generator,
            device=device).mul_(d ** -0.5)
    return inputs


def serve(cfg, batch, prompt_len, gen, device="cuda"):
    """Init, prefill and ``gen - 1`` greedy decode steps (none for an
    encoder-only config). Returns a dict: ``tokens`` (B, gen) or None,
    ``prefill_logits`` and ``logits`` (the last step's; both fp32),
    ``inputs`` (the prefill batch: ``tokens`` and the frontend's
    embeddings), ``weights``, ``cache`` (None encoder-only) and wall
    ``seconds`` of ``init``, ``prefill`` and ``decode`` (all steps), each
    ending in a device synchronize."""
    dev = device_lib.resolve(device)
    decode = cfg.supports_decode
    if decode and gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    t0 = time.perf_counter()
    g = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(0)
    weights = transformer.init(g, cfg, dev, dtype=DTYPE)
    g.manual_seed(1)
    inputs = prefill_inputs(cfg, batch, prompt_len, g, dev)
    cache = transformer.cache_init(cfg, batch, prompt_len + gen, dev) if decode else None
    device_lib.sync(dev)
    t1 = time.perf_counter()
    prefill_logits, cache = transformer.prefill(weights, cfg, inputs, cache,
                                                dtype=DTYPE)
    logits = prefill_logits
    device_lib.sync(dev)
    t2 = time.perf_counter()
    tokens = None
    if decode:
        tok = torch.argmax(logits, -1)[:, None]
        generated = [tok]
        for i in range(gen - 1):
            logits, cache = transformer.decode_step(weights, cfg, tok, cache,
                                                    prompt_len + i, dtype=DTYPE)
            tok = torch.argmax(logits, -1)[:, None]
            generated.append(tok)
        tokens = torch.cat(generated, dim=1)
    device_lib.sync(dev)
    t3 = time.perf_counter()
    return {"tokens": tokens, "prefill_logits": prefill_logits, "logits": logits,
            "inputs": inputs, "weights": weights, "cache": cache,
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
    if out["tokens"] is None:
        print(f"[serve] arch={cfg.name} batch={B} frames={P} "
              "(encoder forward, no decode)")
    else:
        print(f"[serve] arch={cfg.name} batch={B} prompt={P} "
              f"generated={out['tokens'].shape[1]}")
        print("[serve] first row token ids:", out["tokens"][0, :16].tolist(), "...")
    print("[serve] all finite logits:", bool(torch.isfinite(out["logits"]).all()))
    return out


if __name__ == "__main__":
    main()
