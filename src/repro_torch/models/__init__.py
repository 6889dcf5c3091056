"""The port's dense model: layers, the FC hook and the step functions, over
a dense KV slab or a paged KV pool."""
from repro_torch.models.layers import attn_impl, current_attn_impl
from repro_torch.models.linear import current_fc_variant, fc_variant
from repro_torch.models.model import (chunk_logits, decode_step, init_cache,
                                      init_paged_cache, init_params,
                                      model_spec, prefill, prefill_chunk,
                                      prefill_to_pages, prefill_to_slots)
from repro_torch.models.weights import params_from_jax

__all__ = ["attn_impl", "chunk_logits", "current_attn_impl",
           "current_fc_variant", "decode_step", "fc_variant", "init_cache",
           "init_paged_cache", "init_params", "model_spec", "params_from_jax",
           "prefill", "prefill_chunk", "prefill_to_pages", "prefill_to_slots"]
