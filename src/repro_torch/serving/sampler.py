"""Token sampling and speculative acceptance for the serving engine — the
port's `repro.serving.sampler`.

`accept_speculative` is the device-side half of lossless greedy
speculation: the engine's fused speculative iteration calls it on the
device, so the accept-longest-prefix decision never leaves the card.
"""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits [..., V] -> token ids [...] (int32).  `torch.argmax` returns
    the first maximum, as `jnp.argmax` does, so ties break identically."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Temperature + top-k sampling.  ``temperature <= 0`` is greedy;
    ``top_k <= 0`` disables the top-k filter, and ``top_k >= vocab`` is a
    no-op filter (every token survives).  The draw is Gumbel-max over the
    filtered logits with uniforms from `generator` (on the logits'
    device), the categorical draw of `jax.random.categorical`; the random
    stream is torch's own, so the tokens drawn differ from JAX's."""
    if temperature <= 0.0:
        return greedy(logits)
    logits = logits.float() / temperature
    if top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return greedy(logits + gumbel)


def accept_speculative(window: torch.Tensor, target: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorised accept-longest-prefix (lossless greedy speculation).

    window [b, k]: the draft window, window[:, 0] the last committed token
    and window[:, 1:] the proposals; target [b, k]: the target model's
    greedy tokens at each window position.  For each row, `accepted` is
    1 + the length of the longest prefix with ``window[:, i+1] ==
    target[:, i]``: the target's token after the matched prefix is always
    accepted, so accepted lies in [1, k].  Returns ``(out, accepted)``,
    int32, with out[b, j] = target[b, j] for j < accepted[b] and 0 past
    it.  No host synchronisation."""
    b, k = window.shape
    if k == 1:
        return (target.to(torch.int32),
                torch.ones(b, dtype=torch.int32, device=target.device))
    match = (window[:, 1:] == target[:, :-1]).to(torch.int32)    # [b, k-1]
    prefix = torch.cumprod(match, dim=1)
    accepted = 1 + prefix.sum(dim=1)                              # [b] 1..k
    mask = (torch.arange(k, device=target.device)[None, :]
            < accepted[:, None])
    out = torch.where(mask, target, torch.zeros_like(target))
    return out.to(torch.int32), accepted.to(torch.int32)


__all__ = ["accept_speculative", "greedy", "sample"]
