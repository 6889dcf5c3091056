"""Padding-free oracles of the SSM families, from the JAX package.

The reference's prefill pushes a window's zero padding through the conv
and the SSM recurrence (ROADMAP queue 3); the port's stops each row's
state at its prompt's end.  So a ragged prompt's oracle is the reference
run on that prompt alone, never padded:

* `prompt_alone`: its `prefill` at the prompt's own length where the
  chunked scan takes it (one chunk, or a length the chunk divides: `cs =
  min(chunk, l)` must divide l), else its decode path over the prompt as
  one window from a fresh cache;
* `greedy_streams`: every prompt token through its `decode_step` at t = 1
  from a fresh cache, then greedy tokens until eos or the budget, as the
  engine emits them (the eos token included).
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro import models as jm

_prefill = jax.jit(jm.prefill, static_argnums=0)
_decode = jax.jit(jm.decode_step, static_argnums=0)


def prompt_alone(jcfg, jp, prompt, capacity):
    """(last-position logits [V], the one-row cache) of the reference on
    `prompt` alone."""
    n, chunk = len(prompt), jcfg.ssm.chunk_size
    toks = jnp.asarray([prompt], jnp.int32)
    cache = jm.init_cache(jcfg, 1, capacity)
    if n <= chunk or n % chunk == 0:
        logits, cache = _prefill(jcfg, jp, {"tokens": toks}, cache)
        return logits[0], cache
    logits, cache = _decode(jcfg, jp, cache, toks)
    return logits[0, -1], cache


def stack_rows(caches):
    """One batched reference cache from one-row caches: ``pos`` on axis 0,
    every other leaf ([layers or applications, b, ...]) on axis 1."""
    out = {"pos": jnp.concatenate([c["pos"] for c in caches])}
    for key in caches[0]:
        if key != "pos":
            out[key] = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1),
                                    *[c[key] for c in caches])
    return out


def greedy_streams(jcfg, jp, requests, eos_token, capacity):
    """{req_id: (tokens, reason)} of greedy decoding on each prompt alone;
    `requests` holds (req_id, prompt, budget) with the engine's budget."""
    out = {}
    for req_id, prompt, budget in requests:
        cache = jm.init_cache(jcfg, 1, capacity)
        for tok in prompt:
            logits, cache = _decode(jcfg, jp, cache,
                                    jnp.asarray([[tok]], jnp.int32))
        tokens, reason = [], "length"
        while True:
            tok = int(np.argmax(np.asarray(logits[0, -1])))
            tokens.append(tok)
            if tok == eos_token:
                reason = "eos"
                break
            if len(tokens) >= budget:
                break
            logits, cache = _decode(jcfg, jp, cache,
                                    jnp.asarray([[tok]], jnp.int32))
        out[req_id] = (tokens, reason)
    return out
