"""Batched serving engine: prefill + decode with static-shape KV caches.

Serving is one step function, ``decode_step``: one token for the whole
batch against the cache.  Prefill feeds the prompt through it one position
at a time (as the JAX package's engine does), so every block family serves
through the same code.  The cache, the tokens and ``cur_len`` stay on the
session's device across steps; nothing is read back to the host until the
generated tokens are returned.  Greedy decoding (``temperature=0``) picks
the arg-max; above that tokens are drawn by ``torch.multinomial`` from an
explicit generator seeded with ``seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.csr import resolve_device
from repro_torch.models import transformer as tmod


@dataclasses.dataclass
class ServeSession:
    cfg: Any
    params: Any
    cache: Any
    cur_len: torch.Tensor          # 0-d int32 on ``device``
    enc_out: Any = None
    max_len: int = 0               # cache slots a sequence
    filled: int = 0                # host mirror of ``cur_len``

    @property
    def device(self) -> torch.device:
        return self.cur_len.device


def make_decode_fn(cfg):
    @torch.no_grad()
    def step(params, cache, tokens, cur_len, enc_out=None):
        return tmod.decode_step(params, cfg, tokens, cache, cur_len,
                                enc_out=enc_out)
    return step


@torch.no_grad()
def start_session(cfg, params, batch: int, max_len: int, *,
                  frame_embeds=None, device=None) -> ServeSession:
    """A session of ``batch`` sequences with ``max_len`` cache slots each,
    on ``device`` (default: the CUDA card; ``params`` must live there)."""
    dev = resolve_device(device)
    cache = tmod.init_cache(cfg, batch, max_len, device=dev)
    enc_out = None
    if cfg.is_encoder_decoder:
        if frame_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             "frame_embeds")
        enc_out = tmod._run_encoder(
            params, cfg, frame_embeds.to(dev, getattr(torch, cfg.dtype)))
    # a sliding window caps the cache at the window, as init_cache does;
    # the session refuses a write past it (no ring buffer)
    slots = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return ServeSession(cfg, params, cache,
                        torch.zeros((), dtype=torch.int32, device=dev),
                        enc_out, max_len=slots)


def _step(session: ServeSession, decode_fn, tokens: torch.Tensor):
    if session.filled >= session.max_len:
        raise IndexError(f"the session's cache holds {session.max_len} "
                         "positions a sequence; start it with a larger "
                         "max_len (prompt + generated tokens)")
    logits, session.cache = decode_fn(session.params, session.cache, tokens,
                                      session.cur_len, session.enc_out)
    session.cur_len = session.cur_len + 1
    session.filled += 1
    return logits


def prefill(session: ServeSession, prompt: torch.Tensor, decode_fn=None, *,
            all_logits: bool = False):
    """Feed prompt tokens (B, P) one position at a time; returns the last
    logits (B, 1, V), or every position's (B, P, V) with ``all_logits``."""
    decode_fn = decode_fn or make_decode_fn(session.cfg)
    prompt = prompt.to(session.device)
    logits = [_step(session, decode_fn, prompt[:, i:i + 1])
              for i in range(prompt.shape[1])]
    return torch.cat(logits, dim=1) if all_logits else logits[-1]


def generate(session: ServeSession, prompt: torch.Tensor, num_tokens: int, *,
             temperature: float = 0.0, seed: int = 0,
             return_logits: bool = False):
    """Greedy/temperature generation; returns (B, num_tokens) token ids on
    the session's device.  With ``return_logits`` it also returns the
    logits of every position fed, (B, P + num_tokens, V): position ``i``'s
    logits predict token ``i + 1``."""
    if session.filled + prompt.shape[1] + num_tokens > session.max_len:
        raise IndexError(
            f"{prompt.shape[1]} prompt + {num_tokens} generated tokens do not "
            f"fit the session's {session.max_len - session.filled} free "
            "cache positions")
    decode_fn = make_decode_fn(session.cfg)
    logits = prefill(session, prompt, decode_fn, all_logits=return_logits)
    seen = [logits]
    gen = None
    if temperature > 0:
        gen = torch.Generator(device=session.device)
        gen.manual_seed(seed)
    out = []
    vocab = session.cfg.vocab_size
    for _ in range(num_tokens):
        lg = logits[:, -1, :vocab]
        if temperature > 0:
            prob = torch.softmax(lg / temperature, dim=-1)
            tok = torch.multinomial(prob, 1, generator=gen)
        else:
            tok = torch.argmax(lg, dim=-1, keepdim=True)
        tok = tok.to(torch.int32)
        out.append(tok)
        logits = _step(session, decode_fn, tok)
        seen.append(logits)
    tokens = torch.cat(out, dim=1)
    if return_logits:
        return tokens, torch.cat(seen, dim=1)
    return tokens
